"""Encoder fine-tuning in the port (memex_tpu_torch/train) against
memex_tpu's (memex_tpu/train) on the CPU: the InfoNCE loss, the jitted
train step (loss, accuracy, params, Adam's mu, nu and count), the
data-parallel step over several entries, the train-state .npz in both
directions, the SQL pairs and their token ids, and train_encoder end to
end with checkpoint, resume and HF export.

Params are memex_tpu's init_params carried over with params_from_numpy;
batches are drawn from numpy seeds.

Tolerances. Both sides run the step in float32; XLA and PyTorch sum the
same products in other orders, so activations and gradients differ by a
few float32 ulps. After one step at memex_tpu's learning rate (2e-5) the
loss and every leaf agree within STEP_TOL. Adam turns a gradient into an
update of at most ~lr in each coordinate whatever its size, so where a
gradient is rounding noise on both sides (the attention key bias has a
true gradient of zero: softmax ignores a constant added to every key
score) the two updates are unrelated numbers below lr * |g| / eps; over
five steps those coordinates and the moments' ulp differences compound,
hence FIVE_STEP_TOL. (Measured here: the loss within 7e-7, params
within 6e-8 and mu within 5e-8 after five steps.) Two different batch splittings of one step (the
data-parallel case) differ only in the summation order of the gradient
products: SPLIT_TOL.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from memex_tpu.models import minilm as jm
from memex_tpu.train import contrastive as jc
from memex_tpu.train import loop as jl
from memex_tpu_torch.models import minilm as tm
from memex_tpu_torch.train import contrastive as tc_
from memex_tpu_torch.train import loop as tl

STEP_TOL = 1e-5
FIVE_STEP_TOL = 5e-5
SPLIT_TOL = 1e-5
CPU = torch.device("cpu")


def _cfgs():
    kw = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
              intermediate_size=64, compute_dtype="float32")
    return jm.MiniLMConfig(**kw), tm.MiniLMConfig(**kw)


def _batch(seed: int, b: int = 8, length: int = 16) -> dict:
    """Random ids with ragged masks (every row keeps >= 4 tokens)."""
    rng = np.random.default_rng(seed)
    out = {}
    for side in ("q", "d"):
        out[f"{side}_ids"] = rng.integers(5, 128, (b, length)).astype(np.int32)
        lens = rng.integers(4, length + 1, b)
        out[f"{side}_mask"] = (np.arange(length)[None, :] < lens[:, None]).astype(np.int32)
    return out


def _jax_run(tc, batches, seed=0):
    cfg, _ = _cfgs()
    params = jm.init_params(cfg, seed=seed)
    state = jc.init_train_state(cfg, params, tc)
    step = jax.jit(jc.make_train_step(cfg, tc))
    metrics = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _port_state(tc, seed=0, device=CPU):
    cfg_j, cfg = _cfgs()
    sd = tm.params_from_numpy(jax.tree.map(np.asarray, jm.init_params(cfg_j, seed=seed)))
    return cfg, tc_.init_train_state(cfg, sd, tc, device=device)


def _port_run(tc, batches, devices=None, seed=0):
    cfg, state = _port_state(tc, seed, device=(devices or [CPU])[0])
    step = tc_.make_train_step(cfg, tc, devices)
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _port_trees(state) -> dict:
    names = [n for n, _ in state["params"].named_parameters()]
    opt = state["opt"]
    return {"params": tm.params_to_numpy(state["params"]),
            "mu": tm.params_to_numpy(dict(zip(names, opt.moments("mu")))),
            "nu": tm.params_to_numpy(dict(zip(names, opt.moments("nu")))),
            "count": opt.count, "step": state["step"]}


def _jax_trees(state) -> dict:
    adam = state["opt"][1][0]
    return {"params": jax.tree.map(np.asarray, state["params"]),
            "mu": jax.tree.map(np.asarray, adam.mu), "nu": jax.tree.map(np.asarray, adam.nu),
            "count": int(adam.count), "step": int(state["step"])}


def _assert_trees_close(got: dict, want: dict, atol: float) -> None:
    assert got["count"] == want["count"] and got["step"] == want["step"]
    for key in ("params", "mu", "nu"):
        g_leaves = jax.tree_util.tree_flatten_with_path(got[key])[0]
        w_leaves = jax.tree.leaves(want[key])
        assert len(g_leaves) == len(w_leaves)
        for (path, g), w in zip(g_leaves, w_leaves):
            assert g.shape == w.shape, (key, path)
            np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                       err_msg=f"{key}{jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("seed,b", [(0, 4), (1, 8), (2, 16)])
def test_info_nce_loss_matches_jax(seed, b):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 32)).astype(np.float32)
    d = (q + 0.5 * rng.standard_normal((b, 32))).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want_loss, want_acc = jc.info_nce_loss(jnp.asarray(q), jnp.asarray(d), 0.05)
    loss, acc = tc_.info_nce_loss(torch.from_numpy(q), torch.from_numpy(d), 0.05)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6, atol=STEP_TOL)
    assert float(acc) == float(want_acc)


@pytest.mark.parametrize("steps,atol", [(1, STEP_TOL), (5, FIVE_STEP_TOL)])
def test_train_steps_match_jax(steps, atol):
    tc = tc_.TrainConfig()
    batches = [_batch(10 + i) for i in range(steps)]
    want_state, want_m = _jax_run(jc.TrainConfig(), batches)
    got_state, got_m = _port_run(tc, batches)
    for g, w in zip(got_m, want_m):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=0, atol=atol)
        assert g["accuracy"] == w["accuracy"]
    _assert_trees_close(_port_trees(got_state), _jax_trees(want_state), atol)


def test_clipped_step_matches_jax():
    """grad_clip far below the gradient's global norm: the clip engages."""
    cfg, _ = _cfgs()
    batch = _batch(20)
    params = jm.init_params(cfg, seed=0)
    enc = jm.MiniLMEncoder(cfg)

    def loss_fn(p):
        return jc.info_nce_loss(enc.apply(p, batch["q_ids"], batch["q_mask"]),
                                enc.apply(p, batch["d_ids"], batch["d_mask"]), 0.05)[0]

    grads = jax.jit(jax.grad(loss_fn))(params)
    norm = float(jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree.leaves(grads))))
    clip = norm / 8
    want_state, want_m = _jax_run(jc.TrainConfig(grad_clip=clip), [batch])
    got_state, got_m = _port_run(tc_.TrainConfig(grad_clip=clip), [batch])
    np.testing.assert_allclose(got_m[0]["loss"], want_m[0]["loss"], rtol=0, atol=STEP_TOL)
    got, want = _port_trees(got_state), _jax_trees(want_state)
    _assert_trees_close(got, want, STEP_TOL)
    # mu = (1 - b1) * clipped g: the clipped gradient's norm is the clip.
    mu_norm = np.sqrt(sum(float(np.sum(m.astype(np.float64) ** 2))
                          for m in jax.tree.leaves(got["mu"])))
    np.testing.assert_allclose(mu_norm, 0.1 * clip, rtol=1e-4)


def test_optimizer_clips_as_optax_selects():
    """Below the bar the gradient passes bit for bit; above it the result is
    g / |g| * max, with no 1e-6 added to |g| as clip_grad_norm_ adds (at
    |g| = 2e-5 that term would shrink the clipped gradient by ~5%)."""
    unit = torch.tensor([0.6, -0.8, 0.0])
    for norm, clip in ((0.5, 1.0), (2e-5, 1e-5)):
        p = torch.nn.Parameter(torch.zeros(3))
        p.grad = unit * norm
        opt = tc_.ClipAdamW([p], lr=1.0, weight_decay=0.0, grad_clip=clip)
        opt.step()
        mu = opt.state[p]["mu"]  # (1 - b1) * clipped g
        if norm < clip:
            assert torch.equal(mu, unit * norm * (1 - 0.9))
        else:
            torch.testing.assert_close(mu, unit * clip * (1 - 0.9), rtol=1e-5, atol=0)
        assert opt.count == 1


@pytest.mark.parametrize("entries", [2, 4, 8])
def test_dp_sharded_step_matches_single(entries):
    tc = tc_.TrainConfig(learning_rate=1e-3)
    batch = _batch(30, b=16)
    one, m1 = _port_run(tc, [batch])
    many, m2 = _port_run(tc, [batch], devices=[CPU] * entries)
    np.testing.assert_allclose(m2[0]["loss"], m1[0]["loss"], rtol=0, atol=SPLIT_TOL)
    _assert_trees_close(_port_trees(many), _port_trees(one), SPLIT_TOL)


def test_dp_step_takes_the_loss_over_the_global_batch():
    """Every row's negatives are the whole batch: the loss over 4 entries
    equals the loss of the 16 x 16 logits, not the mean of 4 blocks'."""
    tc = tc_.TrainConfig()
    batch = _batch(31, b=16)
    cfg, state = _port_state(tc)
    with torch.no_grad():
        q = state["params"](torch.from_numpy(batch["q_ids"]), torch.from_numpy(batch["q_mask"]))
        d = state["params"](torch.from_numpy(batch["d_ids"]), torch.from_numpy(batch["d_mask"]))
    global_loss = float(tc_.info_nce_loss(q, d, tc.temperature)[0])
    block_loss = np.mean([float(tc_.info_nce_loss(q[i:i + 4], d[i:i + 4], tc.temperature)[0])
                          for i in range(0, 16, 4)])
    _, m = _port_run(tc, [batch], devices=[CPU] * 4)
    np.testing.assert_allclose(m[0]["loss"], global_loss, rtol=0, atol=SPLIT_TOL)
    assert abs(m[0]["loss"] - block_loss) > 100 * SPLIT_TOL


def test_step_is_a_function_of_its_inputs():
    tc = tc_.TrainConfig(learning_rate=1e-3)
    batches = [_batch(40 + i) for i in range(2)]
    a, _ = _port_run(tc, batches)
    b, _ = _port_run(tc, batches)
    _assert_trees_close(_port_trees(a), _port_trees(b), 0.0)


def test_loss_decreases():
    tc = tc_.TrainConfig(learning_rate=1e-3)
    batch = _batch(0)
    cfg, state = _port_state(tc)
    step = tc_.make_train_step(cfg, tc)
    _, m0 = step(state, batch)
    for _ in range(10):
        state, m = step(state, batch)
    assert float(m["loss"]) < float(m0["loss"])
    assert float(m["accuracy"]) >= float(m0["accuracy"])


def test_params_to_numpy_inverts_params_from_numpy():
    cfg_j, cfg = _cfgs()
    tree = jax.tree.map(np.asarray, jm.init_params(cfg_j, seed=3))
    model = tm.MiniLM(cfg)
    model.load_state_dict(tm.params_from_numpy(tree))
    back = tm.params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == np.float32 and a.flags.c_contiguous
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_train_state_npz_resumes_across_packages(tmp_path, direction):
    """Two steps on one side, saved; the other side loads the file and
    takes a third step, which agrees with the first side's third step."""
    tc = tc_.TrainConfig()
    batches = [_batch(50 + i) for i in range(3)]
    cfg_j, cfg = _cfgs()
    path = str(tmp_path / "state.npz")
    j_step = jax.jit(jc.make_train_step(cfg_j, jc.TrainConfig()))
    j_template = jc.init_train_state(cfg_j, jm.init_params(cfg_j, seed=0), jc.TrainConfig())
    p_step = tc_.make_train_step(cfg, tc)
    if direction == "jax_to_port":
        state, _ = _jax_run(jc.TrainConfig(), batches[:2])
        jl.save_train_state(state, path)
        want, _ = j_step(state, batches[2])
        _, got = _port_state(tc, seed=1)  # other params: the file must overwrite them
        got = tl.load_train_state(got, path)
        assert got["step"] == 2 and got["opt"].count == 2
        got, _ = p_step(got, batches[2])
    else:
        state, _ = _port_run(tc, batches[:2])
        tl.save_train_state(state, path)
        want, _ = p_step(state, batches[2])
        got = jl.load_train_state(j_template, path)
        assert int(got["step"]) == 2
        got, _ = j_step(got, batches[2])
    arrs = np.load(path)
    assert len(arrs.files) == 1 + 3 * (5 + 16 * cfg.num_layers) + 1
    assert arrs["arr_0"].dtype == np.int32 and arrs["arr_0"].shape == ()
    g, w = ((_port_trees(got), _jax_trees(want)) if direction == "jax_to_port"
            else (_port_trees(want), _jax_trees(got)))
    _assert_trees_close(g, w, STEP_TOL)


# -- train_encoder --------------------------------------------------------------

DOC = "alpha beta gamma delta epsilon zeta eta theta " * 60


@pytest.fixture(scope="module")
def tiny_model_dir(tmp_path_factory):
    """A hidden-64 MiniLM in HF format with the fallback vocab, written by
    memex_tpu: both packages' engines load it (dense weights to bf16)."""
    from memex_tpu.text.tokenizer import _build_fallback_vocab

    path = str(tmp_path_factory.mktemp("tiny_model"))
    vocab = _build_fallback_vocab()
    cfg = jm.MiniLMConfig(vocab_size=len(vocab), hidden_size=64, num_layers=2, num_heads=4,
                          intermediate_size=128)
    jm.save_params(path, cfg, jm.init_params(cfg, seed=0), vocab=vocab)
    return path


def _runtimes(tmp_path, model_dir, docs=(DOC,)):
    """memex_tpu's Runtime and the port's TorchRuntime (CPU), each with the
    same documents ingested by its own worker."""
    from memex_tpu.config import Settings as JSettings
    from memex_tpu.db import queue as jqueue
    from memex_tpu.runtime import Runtime
    from memex_tpu.worker import Worker as JWorker
    from memex_tpu_torch.config import Settings
    from memex_tpu_torch.db import queue
    from memex_tpu_torch.runtime import TorchRuntime
    from memex_tpu_torch.worker import Worker

    out = []
    for name, settings_cls, rt_cls, q, worker in (
            ("jax", JSettings, Runtime, jqueue, JWorker),
            ("port", Settings, TorchRuntime, queue, Worker)):
        s = settings_cls.from_env(db_uri=f"sqlite://{tmp_path}/{name}.db",
                                  vector_uri="memory://", embedding_model=model_dir)
        s.embedding_dim, s.max_seq_length, s.window_stride = 64, 64, 16
        rt = rt_cls(s) if name == "jax" else rt_cls(s, device="cpu")
        for doc in docs:
            q.enqueue(rt.db, "traincol", doc, q.TaskType.Ingest)
        assert worker(rt, poll_interval=0.01).drain(timeout=120)
        out.append(rt)
    return out


def test_pairs_and_token_ids_match_jax(tmp_path, tiny_model_dir):
    jrt, rt = _runtimes(tmp_path, tiny_model_dir, docs=(DOC, "one short document"))
    pairs = tl.pairs_from_sql(rt, "traincol")
    assert pairs == jl.pairs_from_sql(jrt, "traincol")
    assert len(pairs) > 10
    for got, want in zip(tl._tokenize_pairs(rt.engine, pairs, 32),
                         jl._tokenize_pairs(jrt.engine, pairs, 32)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_train_encoder_matches_jax(tmp_path, tiny_model_dir):
    """Both packages' train_encoder over the same collection: same pairs and
    batches (8 rows: memex_tpu rounds to its 8 virtual devices, the port
    gets 8 cpu entries), metrics within tolerance, a resume that advances
    the step, an export that memex_tpu's load_params reads and the port's
    EmbeddingEngine serves, and the serving engine left as it was."""
    from memex_tpu_torch.embed import EmbeddingEngine

    assert len(jax.devices()) == 8
    jrt, rt = _runtimes(tmp_path, tiny_model_dir)
    before = {k: v.clone() for k, v in rt.engine.model.state_dict().items()}
    kw = dict(epochs=1, batch_size=8, max_len=32)
    want = jl.train_encoder(jrt, "traincol", tc=jc.TrainConfig(learning_rate=1e-4),
                            out_dir=str(tmp_path / "ft_jax"),
                            checkpoint_path=str(tmp_path / "jax_state.npz"), **kw)
    got = tl.train_encoder(rt, "traincol", tc=tc_.TrainConfig(learning_rate=1e-4),
                           out_dir=str(tmp_path / "ft"), checkpoint_path=str(tmp_path / "st.npz"),
                           devices=[CPU] * 8, **kw)
    assert got["pairs"] == want["pairs"] > 8 and got["step"] == want["step"] >= 1
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=FIVE_STEP_TOL)
    assert got["accuracy"] == want["accuracy"]
    for k, v in rt.engine.model.state_dict().items():
        assert torch.equal(v, before[k]), k

    # The export: memex_tpu's loader reads it, and it matches memex_tpu's own.
    cfg, params = jm.load_params(str(tmp_path / "ft"))
    _, want_params = jm.load_params(str(tmp_path / "ft_jax"))
    assert cfg.hidden_size == 64 and cfg.num_layers == 2
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(want_params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=FIVE_STEP_TOL)
    engine = EmbeddingEngine(model_dir=str(tmp_path / "ft"), max_seq_length=32, device="cpu")
    v = engine.encode_single("alpha beta gamma")
    assert np.isfinite(v).all() and abs(float(np.linalg.norm(v)) - 1.0) < 1e-3

    # Resume from the port's checkpoint continues the step counter; the
    # port also resumes from memex_tpu's checkpoint.
    again = tl.train_encoder(rt, "traincol", tc=tc_.TrainConfig(learning_rate=1e-4),
                             resume=str(tmp_path / "st.npz"), devices=[CPU] * 8, **kw)
    assert again["step"] == 2 * got["step"]
    cross = tl.train_encoder(rt, "traincol", tc=tc_.TrainConfig(learning_rate=1e-4),
                             resume=str(tmp_path / "jax_state.npz"), devices=[CPU] * 8, **kw)
    assert cross["step"] == 2 * want["step"]
    np.testing.assert_allclose(cross["loss"], again["loss"], rtol=0, atol=FIVE_STEP_TOL)


def test_train_encoder_shrinks_the_batch_for_a_small_collection(tmp_path, tiny_model_dir):
    _, rt = _runtimes(tmp_path, tiny_model_dir, docs=("alpha beta gamma delta " * 30,))
    n = len(tl.pairs_from_sql(rt, "traincol"))
    assert 2 <= n < 32
    m = tl.train_encoder(rt, "traincol", batch_size=32, max_len=16, devices=[CPU] * 2)
    assert m["pairs"] == n and m["step"] == 1
    with pytest.raises(ValueError, match="minimum batch"):
        tl.train_encoder(rt, "traincol", batch_size=32, max_len=16, devices=[CPU] * (n + 1))
