"""Multi-host bring-up of the port (memex_tpu_torch/parallel/distributed.py):
the counterpart of tests/test_distributed.py, with two real OS processes
joined over gloo on the CPU, each a controller of one `cpu` shard.

The ranks run this file as a script (`_rank_main`): init_multihost, an
all_reduce, then every flat tier of ShardedFlatIndex (fused: the plain
versions of K1-K4; and plain), the tie order across the ranks' shards,
ShardedIVFIndex through build, spill, fold, deletes, the exact fallback
and rebuild, checkpoints, and the `tpu+mesh://` store. Each rank writes
what it saw to a JSON file; the tests here run the same steps on the
port's single controller over ["cpu", "cpu"] (the hits must be
identical, ids and scores) and on memex_tpu's sharded indexes over two of
tests/conftest.py's virtual devices, Pallas in interpret mode (the
sharded tests' 2e-5), and hold the two ranks to the same hits and the
same replicated state. Then `python -m memex_tpu_torch serve` on two
ranks, fed the same requests in lockstep, searched during an ingest, and
restarted on their own checkpoint files. Every subprocess wait has a
timeout of at most 180 s and kills the processes when it expires.

A `gpu`-marked case runs two ranks on two cards over NCCL; run it on a
machine with two or more cards with

    python -m pytest --noconftest -m gpu tests/test_torch_distributed.py
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 32
CARD_D = 384  # on the card: the width the kernels are built and tested for
SCORE_ATOL = 2e-5
WAIT_S = 180  # every subprocess wait; the processes die when it expires
TIERS = [
    dict(dtype="float32"),
    dict(dtype="bfloat16"),
    dict(dtype="int8"),
    dict(dtype="int8", query_quantize=False),
    dict(dtype="int4"),
]
FLAT_CASES = [(t, f) for t in TIERS for f in (True, False)]
IVF_CASES = [dict(use_fused=True), dict(use_fused=False), dict(use_fused=True, refine=True)]
# The scan wrapper each flat tier's fused search calls (K1, K1, K2, K3, K4).
WRAPPERS = {"float32": "fused_score_topk", "bfloat16": "fused_score_topk",
            "int8": "fused_score_topk_int8q", "int8-False": "fused_score_topk_int8",
            "int4": "fused_score_topk_int4_rerank"}


def _case_id(tier: dict, fused=None) -> str:
    name = "-".join(map(str, tier.values()))
    return name if fused is None else f"{name}-{'fused' if fused else 'plain'}"


def _unit(rng, n, d=D):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _clustered(rng, n, d=D, centers=12, sigma=0.07):
    c = _unit(rng, centers, d)
    v = c[rng.integers(0, centers, n)] + sigma * rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _plain(hits) -> list:
    """Hits as JSON gives them back: lists of [id, score]."""
    return json.loads(json.dumps(hits))


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(np.asarray(a)).tobytes()).hexdigest()


# -- the steps both sides run -------------------------------------------------


def flat_steps(make, tier: dict, fused: bool, d: int = D) -> dict:
    """Ingest in three batches, search, delete a query's best rows, re-add
    one, compact past 25% dead rows, grow past capacity: the hits of each
    step and the host state after it."""
    rng = np.random.default_rng(0)
    v = _unit(rng, 3000, d)
    ids = [f"v{i}" for i in range(3000)]
    q = _unit(rng, 5, d) + 0.5 * v[:5]
    ix = make(use_fused=fused, capacity_per_shard=1024, **tier)
    steps, states = [], []

    def step():
        steps.append(_plain(ix.search(q, 10)))
        states.append([list(ix.counts), ix.cap, ix.dead, _digest(sorted(ix.ids.items()))])

    for lo, hi in ((0, 700), (700, 701), (701, 1500)):
        ix.add(v[lo:hi], ids[lo:hi])
    step()
    gone = [sid for sid, _ in ix.search(q[:1], 6)[0]] + ids[:50]
    ix.delete(gone)
    step()
    ix.add(v[:1], ["v0"])
    step()
    ix.delete(ids[100:600])  # > 25% dead: compact
    step()
    ix.add(v[1500:], ids[1500:])  # past 2 x 1024 rows: grow
    step()
    return {"steps": steps, "states": states, "shadow": _digest(ix._sh_rows)}


def tie_steps(make, dtype: str) -> list:
    """Sixteen copies of one row under different ids, over both shards."""
    rng = np.random.default_rng(6)
    v = _unit(rng, 400)
    v[::25] = v[0]
    ix = make(dtype=dtype, use_fused=True)
    ix.add(v, [f"d{i}" for i in range(400)])
    hits = ix.search(v[:1], 16)
    return [_plain(hits), [ix._id_to_row[s] for s, _ in hits[0]], ix.cap]


def _fixed_init(module):
    """k-means from fixed initial rows (the first C of the sample), on the
    ranks and in the single controller alike."""
    fit = module.kmeans_fit

    def fixed(vectors, n_clusters, iters=10, seed=0, **kw):
        return fit(vectors, n_clusters, iters, seed, init=torch.arange(n_clusters))

    module.kmeans_fit = fixed


def ivf_state(ix) -> dict:
    """The state memex_tpu holds replicated, as digests."""
    return {"centroids": _digest(ix.centroids.cpu().numpy()), "sizes": ix._sizes_h.tolist(),
            "mean": _digest(ix.mean), "rowids": _digest(ix._rowids_host()),
            "ids": ix.ids, "spill": _digest(ix.spill._sh_rows),
            "spill_ids": sorted(ix.spill._id_to_row)}


def ivf_steps(make, cfg: dict, d: int = D) -> dict:
    """Build, search, stream a spill, delete from table and spill, fold in
    place, crowd one query's probed clusters with deletes (the exact
    fallback), rebuild."""
    rng = np.random.default_rng(5)
    db = _clustered(rng, 4096, d)
    ids = [f"v{i}" for i in range(4096)]
    qs = _clustered(rng, 8, d)
    ix = make(n_clusters=16, nprobe=6, **cfg)
    out: dict = {"steps": [], "states": []}

    def step():
        out["steps"].append(_plain(ix.search(qs, 10)))
        out["states"].append(ivf_state(ix))

    ix.build(db, ids)
    step()
    extra = _clustered(rng, 200, d)
    ix.add(extra, [f"s{i}" for i in range(200)])
    ix.delete(["v3", "s7", "nope"])
    step()
    out["folded"] = ix.fold_spill()
    step()
    ix.nprobe = 1
    top = [s for s, _ in ix.search(qs[:1], 4096)[0]]  # the one probed cluster's rows
    ix.delete(top[:-3])
    out["fallback"] = _plain(ix.search(qs[:1], 10))
    out["maintenance"] = ix.maintenance_needed
    ix.nprobe = 6
    ix.rebuild()
    step()
    return out


# -- a rank -------------------------------------------------------------------


def _rank_main(coordinator: str, rank: int, out_dir: str, device: str) -> None:
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    import torch.distributed as dist

    import memex_tpu_torch.index.flat as tflat
    import memex_tpu_torch.index.sharded as tsflat
    import memex_tpu_torch.index.sharded_ivf as tsivf
    from memex_tpu_torch.ops import fused_topk as ft
    from memex_tpu_torch.parallel import init_multihost

    # Calls of each scan wrapper from the sharded index, whose shard scan
    # is flat.scan_rows (on the CPU a wrapper runs its kernel's plain
    # version, and launches nothing).
    calls: dict[str, int] = {}
    for name in sorted(set(WRAPPERS.values())):
        def counted(*a, _f=getattr(tflat, name), _n=name, **kw):
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*a, **kw)
        setattr(tflat, name, counted)

    res: dict = {"noop": init_multihost(), "dir": out_dir}  # no MEMEX_COORDINATOR here
    assert init_multihost(coordinator, 2, rank, device=device)
    group = dist.group.WORLD
    d = D if device == "cpu" else CARD_D
    total = torch.ones(1, device=device)
    dist.all_reduce(total)
    res["psum"] = float(total)
    res["backend"] = dist.get_backend()
    _fixed_init(tsivf)

    def flat(**kw):
        return tsflat.ShardedFlatIndex(d, [device], group=group, **kw)

    def ivf(**kw):
        return tsivf.ShardedIVFIndex(d, [device], group=group, **kw)

    res["flat"], res["calls"], res["launches"] = {}, {}, {}
    for tier, fused in FLAT_CASES:
        if device != "cpu" and not fused:
            continue
        calls.clear()
        ft.reset_launches()
        res["flat"][_case_id(tier, fused)] = flat_steps(flat, tier, fused, d)
        res["calls"][_case_id(tier, fused)] = dict(calls)
        res["launches"][_case_id(tier, fused)] = dict(ft.LAUNCHES)
    res["ivf"] = {_case_id(cfg): ivf_steps(ivf, cfg, d) for cfg in IVF_CASES
                  if device == "cpu" or cfg.get("use_fused")}
    if device == "cpu":
        res["ties"] = {dt: tie_steps(flat, dt) for dt in ("float32", "int8")}
        res.update(_rank_checkpoints(flat, ivf, os.path.join(out_dir, f"ckpt{rank}")))
        res["store"] = _rank_store(out_dir)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    dist.destroy_process_group()


def _rank_checkpoints(flat, ivf, out_dir: str) -> dict:
    """Two-rank saves, each rank into its own directory, then a two-rank
    restore of each."""
    rng = np.random.default_rng(7)
    v = _unit(rng, 900)
    q = v[10:14]
    src = flat(dtype="int8", use_fused=False)
    path = os.path.join(out_dir, "col.mesh")
    src.add(v[:600], [f"c{i}" for i in range(600)])
    src.save(path)
    src.add(v[600:], [f"c{i}" for i in range(600, 900)])
    src.delete(["c3", "c700"])
    src.save(path)
    back = flat(dtype="int8", use_fused=False)
    out = {"mesh": {"segments": len(src._segments), "hits": _plain(src.search(q, 10)),
                    "restored": back.restore(path), "back": _plain(back.search(q, 10))}}
    rng = np.random.default_rng(11)
    db = _clustered(rng, 4096)
    src = ivf(n_clusters=16, nprobe=6, use_fused=False)
    src.build(db, [f"v{i}" for i in range(4096)])
    src.add(_clustered(rng, 64), [f"s{i}" for i in range(64)])
    src.delete(["v9", "s2"])
    path = os.path.join(out_dir, "col.ivfmesh")
    src.save(path)
    qs = _clustered(rng, 5)
    back = ivf(n_clusters=16, nprobe=6, use_fused=False)
    out["ivfmesh"] = {"count": src.count, "restored": back.restore(path),
                      "back": _plain(back.search(qs, 10)), "queries": qs.tolist()}
    return out


def _rank_store(out_dir: str) -> list:
    """`tpu+mesh://` through the registry, both ranks in one store
    directory (each writes its copy of the same files): two adds, a delete,
    a search, a checkpoint, a search of the store restored from it, the
    collectives that three ingests with their checkpoint rule call, and
    which of 600 more ingests the store would checkpoint after."""
    from memex_tpu_torch.runtime import TorchRuntime
    from memex_tpu_torch.store import registry
    from memex_tpu_torch.store.base import VectorData

    v = _unit(np.random.default_rng(0), 700)
    rows = [VectorData(id=f"m{i}", document_id=f"doc{i // 4}", text="", vector=v[i])
            for i in range(700)]
    uri = f"tpu+mesh://{out_dir}/store?dtype=int8&capacity_per_shard=1024"
    st = registry.get_vector_storage(uri, "c", dim=D, device="cpu")
    assert st.index.P == 2 and st.index.group is not None
    st.add_vectors(rows[:400])
    st.add_vectors(rows[400:])
    st.delete(["m1", "m2", "nope"])
    seen = [[(h.id, h.score, h.document_id) for h in r] for r in st.search_batch(v[:5], 10)]
    st.checkpoint()
    registry._REGISTRY.drop(uri, "c")
    back = registry.get_vector_storage(uri, "c", dim=D, device="cpu")
    seen.append([(h.id, h.score) for h in back.search(v[7], 3)])
    seen.append(back.count)
    # The worker's side of an ingest, the add and the runtime's checkpoint
    # rule (the first ingest saves), meets no other rank.
    rt = TorchRuntime(device="cpu")
    with _counting_collectives() as met:
        for i in range(3):
            back.add_vectors([VectorData(id=f"n{i}", document_id="new", text="", vector=v[i])])
            rt.maybe_checkpoint("c", back)
    seen.append(met)
    seen.append([n for n in range(3, 603) if back.checkpoint_due()])
    return _plain(seen)


@contextlib.contextmanager
def _counting_collectives():
    """The names of the torch.distributed collectives called inside."""
    import torch.distributed as dist

    names = ["all_gather", "all_gather_object", "all_reduce", "barrier", "broadcast",
             "broadcast_object_list", "gather", "reduce", "scatter"]
    saved = {n: getattr(dist, n) for n in names}
    met: list[str] = []
    for n in names:
        setattr(dist, n, lambda *a, _f=saved[n], _n=n, **kw: (met.append(_n), _f(*a, **kw))[1])
    try:
        yield met
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)


# -- the parent side ------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(out_dir, device: str = "cpu", envs=None) -> list[dict]:
    """This file's `_rank_main` in two processes; each rank's JSON."""
    coord = f"127.0.0.1:{_free_port()}"
    base = {k: v for k, v in os.environ.items()
            if k not in ("XLA_FLAGS", "MEMEX_COORDINATOR", "MEMEX_DIST_BACKEND")}
    base["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), coord, str(r), str(out_dir), device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**base, **(envs[r] if envs else {})}) for r in (0, 1)]
    outs = _wait_all(procs)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    results = []
    for r in (0, 1):
        with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
            results.append(json.load(fh))
    return results


def _wait_all(procs) -> list[str]:
    """Each process's output; all of them killed at the first that does not
    end within WAIT_S."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WAIT_S)
            outs.append(out or "")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _run_ranks(tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def mesh2():
    import jax
    from jax.sharding import Mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs two of memex_tpu's virtual devices (tests/conftest.py)")
    return Mesh(np.array(jax.devices()[:2]), ("shard",))


def _single_flat(**kw):
    from memex_tpu_torch.index.sharded import ShardedFlatIndex

    return ShardedFlatIndex(D, ["cpu", "cpu"], **kw)


def _single_ivf(**kw):
    import memex_tpu_torch.index.sharded_ivf as tsivf

    return tsivf.ShardedIVFIndex(D, ["cpu", "cpu"], **kw)


def same_hits(a, b, atol=SCORE_ATOL):
    """memex_tpu's hits `a` and the port's `b`: scores within atol place by
    place, ids equal except where a near-tie lets two trade places."""
    assert len(a) == len(b)
    for ha, hb in zip(a, b):
        assert len(ha) == len(hb)
        sa = np.array([s for _, s in ha])
        sb = np.array([s for _, s in hb])
        np.testing.assert_allclose(sb, sa, rtol=0, atol=atol)
        for i, ((ia, _), (ib, _)) in enumerate(zip(ha, hb)):
            if ia != ib:
                near = {hb[j][0] for j in range(len(hb)) if abs(sb[j] - sa[i]) <= 2 * atol}
                assert ia in near or abs(sa[i] - sa[-1]) <= 2 * atol, (i, ha, hb)


def test_init_multihost_is_a_noop_without_a_coordinator(monkeypatch):
    from memex_tpu_torch.parallel import init_multihost

    monkeypatch.delenv("MEMEX_COORDINATOR", raising=False)
    assert init_multihost() is False
    import torch.distributed as dist

    assert not dist.is_initialized()


def test_backend_follows_the_device_unless_overridden(monkeypatch):
    from memex_tpu_torch.parallel.distributed import backend_for

    monkeypatch.delenv("MEMEX_DIST_BACKEND", raising=False)
    assert (backend_for("cpu"), backend_for("cuda:0")) == ("gloo", "nccl")
    monkeypatch.setenv("MEMEX_DIST_BACKEND", "gloo")
    assert backend_for("cuda") == "gloo"


def test_two_ranks_join_and_all_reduce(ranks):
    """The psum of tests/test_distributed.py: an all_reduce of ones sums to
    the world size; without a coordinator init_multihost did nothing."""
    for res in ranks:
        assert res["noop"] is False
        assert res["psum"] == 2.0 and res["backend"] == "gloo"


@pytest.mark.parametrize("tier,fused", FLAT_CASES,
                         ids=[_case_id(t, f) for t, f in FLAT_CASES])
def test_flat_tiers_match_the_single_controller_and_memex_tpu(ranks, mesh2, tier, fused):
    """Both ranks return the hits of the port's single controller over the
    same two shards, ids and scores identical, with the same host state;
    memex_tpu's index over two devices returns the same within 2e-5. The
    fused searches launch their kernel's plain version once a search on
    each rank's one shard."""
    from memex_tpu.index.sharded import ShardedFlatIndex as JaxSharded

    case = _case_id(tier, fused)
    want = flat_steps(_single_flat, tier, fused)
    for res in ranks:
        assert res["flat"][case] == want, case
    assert ranks[0]["launches"][case] == ranks[1]["launches"][case]

    def jax_make(**kw):
        jx = JaxSharded(D, mesh2, **kw)
        jx._interpret = True
        return jx

    got = flat_steps(jax_make, tier, fused)
    for a, b in zip(got["steps"], want["steps"]):
        same_hits(a, b)
    assert [s[:3] for s in got["states"]] == [s[:3] for s in want["states"]]


def test_each_rank_scans_its_shard_once_a_search(ranks):
    """A rank's fused search calls its tier's scan wrapper once for its one
    shard (six searches: five steps and the delete's lookup; a shortfall
    rerun is plain), and no other wrapper; a plain search calls none."""
    for res in ranks:
        for tier, fused in FLAT_CASES:
            want = {WRAPPERS[_case_id(tier)]: 6} if fused else {}
            assert res["calls"][_case_id(tier, fused)] == want, (tier, fused)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_rows_duplicated_across_ranks_tie_to_the_lower_global_row(ranks, mesh2, dtype):
    """Copies of one row on both ranks' shards: equal scores, listed in
    global-row order (rank 0's shard first), as memex_tpu's lax.top_k
    over its all_gather lists them."""
    from memex_tpu.index.sharded import ShardedFlatIndex as JaxSharded

    hits, rows, cap = ranks[0]["ties"][dtype]
    assert ranks[1]["ties"][dtype] == [hits, rows, cap]
    assert tie_steps(_single_flat, dtype) == [hits, rows, cap]
    assert rows == sorted(rows) and {r // cap for r in rows} == {0, 1}
    assert len({s for _, s in hits[0]}) == 1
    jx = JaxSharded(D, mesh2, dtype=dtype, use_fused=True)
    jx._interpret = True
    v = _unit(np.random.default_rng(6), 400)
    v[::25] = v[0]
    jx.add(v, [f"d{i}" for i in range(400)])
    assert [s for s, _ in jx.search(v[:1], 16)[0]] == [s for s, _ in hits[0]]


@pytest.mark.parametrize("cfg", IVF_CASES, ids=[_case_id(c) for c in IVF_CASES])
def test_sharded_ivf_matches_the_single_controller(ranks, cfg):
    """Hits identical to the single controller over two cpu shards at
    every step (the fold's count, the exact fallback and its maintenance
    flag too), and the state memex_tpu holds replicated (centroids,
    sizes, mean, row ids, id table, the spill's host shadow) bit-equal
    across the ranks and to the single controller's."""
    import memex_tpu_torch.index.sharded_ivf as tsivf

    case = _case_id(cfg)
    fit = tsivf.kmeans_fit
    try:
        _fixed_init(tsivf)
        want = ivf_steps(_single_ivf, cfg)
    finally:
        tsivf.kmeans_fit = fit
    assert ranks[0]["ivf"][case]["states"] == ranks[1]["ivf"][case]["states"]
    for res in ranks:
        assert res["ivf"][case] == want, case
    assert want["folded"] > 0 and want["maintenance"] is True
    assert len(want["fallback"][0]) == 10


def _same_checkpoint_files(a: str, b: str) -> None:
    """Two directories hold the same checkpoint files, array for array."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and not [n for n in names if ".tmp" in n]
    for name in names:
        if name.endswith(".npz"):
            with np.load(os.path.join(a, name)) as x, np.load(os.path.join(b, name)) as y:
                assert sorted(x.files) == sorted(y.files), name
                for f in x.files:
                    np.testing.assert_array_equal(x[f], y[f], err_msg=f"{name}:{f}")
        else:
            with open(os.path.join(a, name)) as x, open(os.path.join(b, name)) as y:
                assert x.read() == y.read(), name


def test_two_rank_checkpoints_restore_in_one_controller_and_in_memex_tpu(ranks, mesh2):
    """Each of two ranks writes the same `.mesh` and `.ivfmesh` files into
    its own directory (as every memex_tpu process does); they restore on
    both ranks, in the port's single controller (identical hits) and in
    memex_tpu's indexes over two devices (within 2e-5)."""
    from memex_tpu.index.sharded import ShardedFlatIndex as JaxSharded
    from memex_tpu.index.sharded_ivf import ShardedIVFIndex as JaxSIVF

    import memex_tpu_torch.index.sharded_ivf as tsivf

    mesh_res, ivf_res = ranks[0]["mesh"], ranks[0]["ivfmesh"]
    assert ranks[1]["mesh"] == mesh_res and ranks[1]["ivfmesh"] == ivf_res
    dirs = [os.path.join(ranks[0]["dir"], f"ckpt{r}") for r in (0, 1)]
    _same_checkpoint_files(*dirs)
    v = _unit(np.random.default_rng(7), 900)
    q = v[10:14]
    assert mesh_res["segments"] == 2 and mesh_res["restored"] == 898
    assert mesh_res["back"] == mesh_res["hits"]
    qs = np.asarray(ivf_res["queries"], np.float32)
    assert ivf_res["restored"] == ivf_res["count"] == 4096 + 64 - 2
    for path in dirs:
        one = _single_flat(dtype="int8", use_fused=False)
        assert one.restore(os.path.join(path, "col.mesh")) == 898
        assert _plain(one.search(q, 10)) == mesh_res["back"]
        one = tsivf.ShardedIVFIndex(D, ["cpu", "cpu"], n_clusters=16, nprobe=6,
                                    use_fused=False)
        assert one.restore(os.path.join(path, "col.ivfmesh")) == ivf_res["count"]
        assert _plain(one.search(qs, 10)) == ivf_res["back"]
    path = dirs[1]
    jx = JaxSharded(D, mesh2, dtype="int8", use_fused=False)
    assert jx.restore(os.path.join(path, "col.mesh")) == 898
    same_hits(jx.search(q, 10), mesh_res["back"])
    jx = JaxSIVF(D, mesh2, n_clusters=16, nprobe=6, use_fused=False, interpret=True)
    jx.spill._interpret = True
    assert jx.restore(os.path.join(path, "col.ivfmesh")) == ivf_res["count"]
    np.testing.assert_array_equal(np.asarray(jx.centroids), one.centroids.numpy())
    same_hits(jx.search(qs, 10), ivf_res["back"])
    assert "v9" not in {s for h in ivf_res["back"] for s, _ in h}


def test_mesh_store_on_two_ranks_gives_both_the_same_hits(ranks):
    """`tpu+mesh://` through the registry on two ranks (one cpu shard
    each): adds, a delete, search_batch, a checkpoint and a restart give
    both ranks the same hits; each query finds its own row first. Under
    the group the store saves after ingests counted alike on every rank,
    and an ingest with its checkpoint calls no collective, so it may run
    beside a search."""
    seen = ranks[0]["store"]
    assert ranks[1]["store"] == seen
    hits, restarted, count, met, due = seen[:5], seen[5], seen[6], seen[7], seen[8]
    assert count == 698
    assert met == []
    assert due == [256, 512]  # after the first ingest, every CHECKPOINT_EVERY-th
    assert [h[0][0] for h in hits[::3]] == ["m0", "m3"] and hits[4][0][0] == "m4"
    assert hits[1][0][0] != "m1" and hits[2][0][0] != "m2"
    assert restarted[0][0] == "m7"


# -- two ranks of `serve` ---------------------------------------------------------


def _http(port: int, method: str, path: str, body=None) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


class _Ranks:
    """Two ranks of `python -m memex_tpu_torch serve --device cpu`
    (MEMEX_COORDINATOR, one SQLite file and `tpu+mesh://` store directory
    each), started together and stopped together."""

    def __init__(self, tmp_path, model_dir):
        coord = f"127.0.0.1:{_free_port()}"
        self.ports = [_free_port(), _free_port()]
        self.procs = []
        for r in (0, 1):
            env = {k: v for k, v in os.environ.items()
                   if k not in ("XLA_FLAGS", "MEMEX_DIST_BACKEND", "OPENAI_API_KEY")}
            env.update(MEMEX_COORDINATOR=coord, MEMEX_NUM_PROCESSES="2",
                       MEMEX_PROCESS_ID=str(r), EMBEDDING_MODEL=str(model_dir),
                       OMP_NUM_THREADS="2", MEMEX_FAKE_LLM="1",
                       DATABASE_CONNECTION=f"sqlite://{tmp_path}/rank{r}.db",
                       VECTOR_CONNECTION=f"tpu+mesh://{tmp_path}/vectors{r}",
                       PYTHONPATH=os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH"))
                                                  if p))
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "memex_tpu_torch", "serve", "--roles", "Api,Worker",
                 "--device", "cpu", "--host", "127.0.0.1", "--port", str(self.ports[r])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                cwd=str(tmp_path), env=env))
        self.deadline = time.monotonic() + WAIT_S
        try:
            for port in self.ports:
                while True:
                    try:
                        _http(port, "GET", "/api/health")
                        break
                    except OSError:
                        assert time.monotonic() < self.deadline, "a rank did not come up"
                        assert all(p.poll() is None for p in self.procs), "a rank exited"
                        time.sleep(0.2)
        except BaseException:
            self.stop()
            raise

    def post(self, doc: str) -> list:
        """The document posted to both ranks; their task ids."""
        return [_http(port, "POST", "/api/collections/c", {"content": doc})
                ["result"]["taskId"] for port in self.ports]

    def wait(self, tasks: list) -> None:
        for port, task in zip(self.ports, tasks):
            while _http(port, "GET", f"/api/tasks/{task}")["result"]["status"] != "Completed":
                assert time.monotonic() < self.deadline, "a task did not complete"
                time.sleep(0.05)

    def search(self, query: str) -> list:
        """The search sent to both ranks at once; both answers."""
        with ThreadPoolExecutor(2) as pool:
            return list(pool.map(lambda port: _http(
                port, "POST", "/api/collections/c/search",
                {"query": query, "limit": 3})["result"], self.ports))

    def stop(self) -> list:
        """Both ranks terminated together; (return code, output) each."""
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        outs = _wait_all(self.procs)
        return [(p.returncode, out[-3000:]) for p, out in zip(self.procs, outs)]


DOCS = [f"document {i} about {w} and {w2}" for i, (w, w2) in enumerate(
    zip(["foxes", "dogs", "rivers", "stars", "trains", "songs", "clouds", "forks", "lamps"],
        ["hills", "cats", "boats", "moons", "roads", "poems", "sands", "drums", "gates"]))]
LOCKSTEP, OVERLAPPED = DOCS[:6], DOCS[6:]


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    """Two ranks of serve: six documents posted to both in lockstep (both
    tasks complete before the next), a search of each sent to both at once;
    three more documents, each searched for as soon as it is posted (while
    its ingest may be in flight; the next is posted once both complete);
    searches of all; then both stopped, restarted on their own files, and
    searched again."""
    from memex_tpu_torch.models.minilm import MiniLM, MiniLMConfig, save_params
    from memex_tpu_torch.text.tokenizer import _build_fallback_vocab

    tmp_path = tmp_path_factory.mktemp("serve")
    model_dir = tmp_path / "model"
    vocab = _build_fallback_vocab()
    cfg = MiniLMConfig(vocab_size=len(vocab), hidden_size=384, num_layers=1, num_heads=6,
                       intermediate_size=128)
    save_params(str(model_dir), cfg, MiniLM(cfg).init_random(0), vocab=vocab)
    queries = DOCS + ["foxes and moons"]
    out: dict = {"dir": tmp_path}
    ranks = _Ranks(tmp_path, model_dir)
    try:
        for doc in LOCKSTEP:
            ranks.wait(ranks.post(doc))
        out["lockstep"] = [ranks.search(q) for q in LOCKSTEP + queries[-1:]]
        out["during_ingest"] = []
        for doc in OVERLAPPED:
            tasks = ranks.post(doc)
            out["during_ingest"].append(ranks.search(doc))
            ranks.wait(tasks)
        out["before"] = [ranks.search(q) for q in queries]
    finally:
        out["stopped"] = ranks.stop()
    ranks = _Ranks(tmp_path, model_dir)
    try:
        out["after"] = [ranks.search(q) for q in queries]
    finally:
        out["restopped"] = ranks.stop()
    return out


def test_serve_on_two_ranks_answers_in_lockstep(serve_runs):
    """Fed the same requests in lockstep, the two ranks answer every search
    with the same hits, each document's own search finds it first, and
    both shut down cleanly (each writes its final checkpoint)."""
    for rc, out in serve_runs["stopped"]:
        assert rc == 0, out
    for (a, b), q in zip(serve_runs["lockstep"], LOCKSTEP + ["foxes and moons"]):
        assert a == b, q
        assert len(a["results"]) == 3
        if q in LOCKSTEP:
            assert a["results"][0]["content"] == q


def test_serve_on_two_ranks_takes_a_search_during_an_ingest(serve_runs):
    """A search sent as soon as a document is posted, while its ingest may
    be in flight: the worker's ingest and checkpoint meet no other rank
    (test_mesh_store_on_two_ranks_gives_both_the_same_hits counts their
    collectives), so the search's all_gather pairs with the other rank's
    and both ranks answer. An answer may lack the new row, or hold one hit
    fewer where one rank's shard already scans a row whose id the other
    rank has yet to learn (hence the contract: no search while an ingest
    is in flight). Once the ingest completes the ranks agree again."""
    for pair in serve_runs["during_ingest"]:
        for answer in pair:
            hits = answer["results"]
            assert 2 <= len(hits) <= 3 and {h["content"] for h in hits} <= set(DOCS)
    for (a, b), q in zip(serve_runs["before"], DOCS + ["foxes and moons"]):
        assert a == b, q
        if q in DOCS:
            assert a["results"][0]["content"] == q


def test_serve_on_two_ranks_restarts_from_their_own_checkpoints(serve_runs):
    """Each rank wrote the same checkpoint files into its own directory;
    restarted on them, both ranks give the hits they gave before."""
    for rc, out in serve_runs["restopped"]:
        assert rc == 0, out
    base = serve_runs["dir"]
    assert (base / "vectors0" / "c.mesh.meta.json").exists()
    _same_checkpoint_files(str(base / "vectors0"), str(base / "vectors1"))
    for (a, b), before in zip(serve_runs["after"], serve_runs["before"]):
        assert a == b == before[0]


@pytest.mark.gpu
def test_two_ranks_on_two_cards_over_nccl(tmp_path):
    """Two ranks, one card each (CUDA_VISIBLE_DEVICES), over NCCL: the
    fused flat tiers (K1-K4) and the sharded IVF (K5) give both ranks the
    hits of one controller over both cards, which launches each kernel
    once a shard as the ranks do."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    import memex_tpu_torch.index.sharded_ivf as tsivf
    from memex_tpu_torch.index.sharded import ShardedFlatIndex
    from memex_tpu_torch.ops import fused_topk as ft

    torch.backends.cuda.matmul.allow_tf32 = False
    ranks = _run_ranks(tmp_path, device="cuda",
                       envs=[{"CUDA_VISIBLE_DEVICES": str(r)} for r in (0, 1)])
    cards = ["cuda:0", "cuda:1"]
    for tier in TIERS:
        case = _case_id(tier, True)
        ft.reset_launches()
        want = flat_steps(lambda **kw: ShardedFlatIndex(CARD_D, cards, **kw), tier, True,
                          CARD_D)
        assert ranks[0]["flat"][case] == ranks[1]["flat"][case] == want, case
        one = {k: v for k, v in ft.LAUNCHES.items() if v}
        assert one and all(ranks[r]["launches"][case] == {k: v // 2 for k, v in
                                                          ft.LAUNCHES.items()} for r in (0, 1))
    fit = tsivf.kmeans_fit
    try:
        _fixed_init(tsivf)
        for cfg in IVF_CASES:
            if not cfg.get("use_fused"):
                continue
            want = ivf_steps(lambda **kw: tsivf.ShardedIVFIndex(CARD_D, cards, **kw), cfg,
                             CARD_D)
            assert ranks[0]["ivf"][_case_id(cfg)] == ranks[1]["ivf"][_case_id(cfg)] == want
    finally:
        tsivf.kmeans_fit = fit
    assert ranks[0]["backend"] == "nccl"


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4])
