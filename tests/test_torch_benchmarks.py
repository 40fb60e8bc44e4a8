"""The port's recall/QPS harness (memex_tpu_torch/benchmarks/) against
memex_tpu's (memex_tpu/benchmarks/) on the same numpy inputs, on the CPU.

- Corpora and queries are the same numpy draws: compared bit for bit.
- Oracles are compared exactly (the same float32 scores and sorts).
- Recall of the flat and HNSW tiers is compared exactly: the port's plain
  scans reproduce memex_tpu's arithmetic, and HNSW is the same native
  library on the same rows. IVF recall is held within IVF_TOL = 0.05:
  k-means draws its initial centroids from jax.random in memex_tpu and
  from a torch.Generator in the port, so the two indexes' clusters differ,
  and the draw, not the arithmetic, decides a boundary hit. Both must also
  pass memex_tpu's own bar of 0.5.
"""

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from memex_tpu.benchmarks import datasets as jds
from memex_tpu.benchmarks import hnsw_recall as jhr
from memex_tpu.benchmarks import llm_bench as jlb
from memex_tpu.benchmarks import run as jrun
from memex_tpu_torch.benchmarks import datasets as tds
from memex_tpu_torch.benchmarks import hnsw_recall as thr
from memex_tpu_torch.benchmarks import llm_bench as tlb
from memex_tpu_torch.benchmarks import run as trun
from memex_tpu_torch.index import FlatIndex, IVFIndex

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
IVF_TOL = 0.05
K = 10
LLM_BENCH_KEYS = {"geometry", "params_m", "param_dtype", "prompt_len", "max_new",
                  "compile_s", "batch_tok_per_s", "prefill_ms", "stream_tok_per_s",
                  "first_token_ms", "backend"}


# -- datasets -------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["clustered", "uniform"])
@pytest.mark.parametrize("seed", [0, 7])
def test_corpus_and_queries_are_memex_tpus_bit_for_bit(kind, seed):
    tc = tds.make_corpus(2000, 48, kind=kind, seed=seed)
    jc = jds.make_corpus(2000, 48, kind=kind, seed=seed)
    assert tc.dtype == jc.dtype and tc.shape == jc.shape
    assert tc.tobytes() == jc.tobytes()
    tq, jq = tds.make_queries(tc, 9, seed=seed + 1), jds.make_queries(jc, 9, seed=seed + 1)
    assert tq.tobytes() == jq.tobytes()


@pytest.mark.parametrize("kind", ["clustered", "uniform"])
def test_oracle_equals_memex_tpus(kind):
    corpus = tds.make_corpus(20_000, 32, kind=kind)
    queries = tds.make_queries(corpus, 8)
    np.testing.assert_array_equal(tds.oracle_topk(corpus, queries, K),
                                  jds.oracle_topk(corpus, queries, K))


def test_oracle_matches_argsort():
    """memex_tpu's test_oracle_matches_argsort, on the port."""
    corpus = tds.make_corpus(500, 32, kind="uniform")
    queries = tds.make_queries(corpus, 4)
    expect = np.argsort(-(queries @ corpus.T), axis=1)[:, :5]
    np.testing.assert_array_equal(tds.oracle_topk(corpus, queries, 5, device="cpu"), expect)


@pytest.mark.parametrize("kind", ["clustered", "uniform"])
def test_device_oracle_on_the_cpu_equals_the_numpy_oracle(kind):
    corpus = tds.make_corpus(3000, 48, kind=kind)
    queries = tds.make_queries(corpus, 16)
    got = tds._oracle_topk_device(corpus, queries, K, device="cpu", block=512)
    np.testing.assert_array_equal(got, tds.oracle_topk(corpus, queries, K))


def test_device_oracle_breaks_ties_to_the_lower_row_across_blocks():
    """Rows 3 and 515 (blocks 0 and 1) are one vector, and so are 700 and
    1300: each pair ties, and the stable host merge keeps the lower row
    first."""
    corpus = tds.make_corpus(1536, 16, kind="uniform", seed=3)
    corpus[515] = corpus[3]
    corpus[1300] = corpus[700]
    queries = np.stack([corpus[3], corpus[700]])
    got = tds._oracle_topk_device(corpus, queries, 4, device="cpu", block=512)
    assert got[0, :2].tolist() == [3, 515]
    assert got[1, :2].tolist() == [700, 1300]


# -- run.bench_tier / run.main ------------------------------------------------------

@pytest.fixture(scope="module")
def bench_data():
    corpus = tds.make_corpus(3000, 48)
    return corpus, tds.make_queries(corpus, 4)


@pytest.mark.parametrize("tier", ["flat", "flat_bf16", "flat_int8", "ivf", "hnsw"])
def test_bench_tier_gives_memex_tpus_keys_and_recall(bench_data, tier):
    corpus, queries = bench_data
    got = trun.bench_tier(tier, corpus, queries, k=5, repeats=1, device="cpu")
    ref = jrun.bench_tier(tier, corpus, queries, k=5, repeats=1)
    assert list(got) == list(ref)
    for key in ("tier", "n", "dim", "k", "q"):
        assert got[key] == ref[key]
    assert got["recall_at_k"] >= 0.5, got  # memex_tpu's bar
    assert got["qps"] > 0 and got["search_batch_ms"] > 0
    if tier == "ivf":
        # Both recalls are rounded to 4 decimals: so is their difference.
        assert round(abs(got["recall_at_k"] - ref["recall_at_k"]), 4) <= IVF_TOL, (got, ref)
    else:
        assert got["recall_at_k"] == ref["recall_at_k"], (got, ref)


def test_bench_tier_rejects_an_unknown_tier(bench_data):
    corpus, queries = bench_data
    with pytest.raises(ValueError, match="unknown tier"):
        trun.bench_tier("scann", corpus, queries, k=5, device="cpu")


def test_run_main_prints_one_line_a_tier(capsys):
    rc = trun.main(["--n", "2000", "--dim", "32", "--q", "4", "--k", "5", "--repeats", "1",
                    "--tiers", "flat, flat_int8,,ivf_int8", "--device", "cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(line) for line in lines]
    assert [r["tier"] for r in rows] == ["flat", "flat_int8", "ivf_int8"]
    assert all(r["n"] == 2000 and r["dim"] == 32 and r["k"] == 5 for r in rows)


@pytest.mark.parametrize("module, args", [
    ("memex_tpu_torch.benchmarks.run", ["--n", "500", "--dim", "16", "--tiers", "flat"]),
    ("memex_tpu_torch.benchmarks.llm_bench", ["--geometry", "tiny"]),
])
def test_the_default_device_does_not_fall_back_to_the_cpu(module, args):
    """With CUDA hidden and no `--device cpu`, the command fails and prints
    no result, as `serve` does."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                          text=True, timeout=120, env=env, cwd=str(ROOT))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "--device cpu" in proc.stderr


# -- hnsw_recall ----------------------------------------------------------------------

def test_hnsw_corpus_queries_and_exact_oracle_are_memex_tpus():
    tc = thr.make_corpus(3000, 64, seed=11, centers=128)
    jc = jhr.make_corpus(3000, 64, seed=11, centers=128)
    assert tc.tobytes() == jc.tobytes()
    tq = thr.make_queries(16, 64, seed=11, centers=128)
    assert tq.tobytes() == jhr.make_queries(16, 64, seed=11, centers=128).tobytes()
    np.testing.assert_array_equal(thr.exact_topk_host(tc, tq, K, block=1000),
                                  jhr.exact_topk_host(jc, tq, K, block=1000))
    assert (thr.M_REF, thr.EFC_REF, thr.EF_SEARCH_REF) == (jhr.M_REF, jhr.EFC_REF,
                                                            jhr.EF_SEARCH_REF)
    assert thr.DEFAULT_CACHE == jhr.DEFAULT_CACHE
    assert thr._cache_paths("d", 3000, 64, 11) == jhr._cache_paths("d", 3000, 64, 11)


@pytest.fixture(scope="module")
def small_graph_data():
    corpus = thr.make_corpus(2000, 32, seed=5, centers=64)
    return corpus, thr.make_queries(16, 32, seed=5, centers=64)


def test_build_or_load_round_trips_and_reads_memex_tpus_graph(tmp_path, small_graph_data):
    corpus, queries = small_graph_data
    assert thr.build_or_load(corpus, seed=5, cache_dir=str(tmp_path / "none"),
                             build_if_missing=False) == (None, 0.0)
    # A graph memex_tpu built and cached loads in the port: a hit, the same ids.
    jax_dir = str(tmp_path / "jax")
    jgraph, j_build_s = jhr.build_or_load(corpus, seed=5, cache_dir=jax_dir)
    assert j_build_s > 0
    tgraph, t_build_s = thr.build_or_load(corpus, seed=5, cache_dir=jax_dir)
    assert t_build_s == 0.0 and tgraph is not None
    np.testing.assert_array_equal(tgraph.search(queries, K), jgraph.search(queries, K))
    # The port's own build: cached, then read back as a hit with its ids.
    own_dir = str(tmp_path / "torch")
    built, build_s = thr.build_or_load(corpus, seed=5, cache_dir=own_dir)
    assert build_s > 0
    again, again_s = thr.build_or_load(corpus, seed=5, cache_dir=own_dir)
    assert again_s == 0.0
    np.testing.assert_array_equal(again.search(queries, K), built.search(queries, K))
    assert thr.recall_against(thr.exact_topk_host(corpus, queries, K),
                              built.search(queries, K)) > 0.5


def test_build_or_load_rebuilds_on_a_stale_probe(tmp_path, small_graph_data):
    corpus, _ = small_graph_data
    cache = str(tmp_path)
    thr.build_or_load(corpus, seed=5, cache_dir=cache)
    _, meta_path = thr._cache_paths(cache, *corpus.shape, 5)
    with open(meta_path, encoding="utf-8") as fh:
        meta = json.load(fh)
    meta["probe"] += 1.0  # another corpus stream under the same tag
    with open(meta_path, "w", encoding="utf-8") as fh:
        json.dump(meta, fh)
    assert thr.build_or_load(corpus, seed=5, cache_dir=cache,
                             build_if_missing=False) == (None, 0.0)
    _, build_s = thr.build_or_load(corpus, seed=5, cache_dir=cache)
    assert build_s > 0


def test_recall_against_skips_padding():
    exact = np.array([[1, 2, 3, 4]])
    assert thr.recall_against(exact, np.array([[4, -1, 2, 9]])) == 0.5
    assert thr.recall_against(exact, np.array([[4, -1, 2, 9]])) == jhr.recall_against(
        exact, np.array([[4, -1, 2, 9]]))


def _flat_recall(corpus, queries, exact, dtype, **kw) -> float:
    idx = FlatIndex(dim=corpus.shape[1], capacity=corpus.shape[0], dtype=dtype, device=CPU,
                    **kw)
    idx.add(corpus, [f"r{i}" for i in range(corpus.shape[0])])
    hits = idx.search(queries, K)
    return float(np.mean([len({int(s[1:]) for s, _ in hits[i]} & set(exact[i].tolist())) / K
                          for i in range(len(queries))]))


def _ivf_recall(corpus, queries, exact, n_clusters, nprobe) -> float:
    idx = IVFIndex(dim=corpus.shape[1], n_clusters=n_clusters, nprobe=nprobe, dtype="int8",
                   use_fused=False, device=CPU)
    idx.build(corpus, [f"r{i}" for i in range(corpus.shape[0])])
    idx.calibrate_operating_point(target_recall=0.95)
    hits = idx.search(queries, K)
    return float(np.mean([len({int(s[1:]) for s, _ in hits[i]} & set(exact[i].tolist())) / K
                          for i in range(len(queries))]))


def test_every_tier_beats_hnsw_small(tmp_path):
    """memex_tpu's tests/test_hnsw_baseline.py::test_every_tier_beats_hnsw_small
    on the port's tiers (the CPU's plain scans): 8,192 x 384 around 2,048
    centres, 64 queries, the reference's HNSW parameters; every tier at or
    above HNSW's recall, and HNSW's recall memex_tpu's."""
    corpus = thr.make_corpus(8192, 384, seed=4242, centers=2048)
    queries = thr.make_queries(64, 384, seed=4242, centers=2048)
    exact = thr.exact_topk_host(corpus, queries, K)
    graph, _ = thr.build_or_load(corpus, seed=4242, cache_dir=str(tmp_path))
    got = graph.search(queries, K, ef=thr.EF_SEARCH_REF)
    hnsw_rec = thr.recall_against(exact, got)
    assert 0.3 < hnsw_rec < 1.0, hnsw_rec
    jgraph, _ = jhr.build_or_load(corpus, seed=4242, cache_dir=str(tmp_path))
    assert jhr.recall_against(exact, jgraph.search(queries, K, ef=jhr.EF_SEARCH_REF)) == hnsw_rec

    tiers = {
        "f32": _flat_recall(corpus, queries, exact, "float32"),
        "bf16": _flat_recall(corpus, queries, exact, "bfloat16"),
        "int8": _flat_recall(corpus, queries, exact, "int8", query_quantize=False),
        "int8q": _flat_recall(corpus, queries, exact, "int8"),
        "int4": _flat_recall(corpus, queries, exact, "int4"),
        "ivf_int8": _ivf_recall(corpus, queries, exact, n_clusters=64, nprobe=8),
    }
    for tier, rec in tiers.items():
        assert rec >= hnsw_rec, (tier, rec, hnsw_rec, tiers)


# -- llm_bench ------------------------------------------------------------------------

def _tensor_leaves(tree):
    if isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensor_leaves(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def test_stream_decode_bench_never_reuses_a_spent_carry():
    """memex_tpu's TestLlmBenchDonationDiscipline on the port. The port's
    decode_chunk writes the KV cache in place, so the carry passed to it is
    spent: its cache tensors live on in the next carry at a new version,
    its other leaves are replaced. A leaf is keyed by its identity and its
    version counter (which every in-place write bumps), so every key passed
    to decode_fn is dead afterwards, and passing a dead one, as a second
    use of a spent carry would, fails the test."""
    from memex_tpu_torch.llm.local.model import (
        LlamaConfig, SamplerConfig, decode_chunk, init_params, prefill,
    )

    cfg = LlamaConfig.tiny()
    params = init_params(cfg, seed=0, device=CPU)
    sc = SamplerConfig()
    prompt = torch.tensor([[5, 6, 7, 8]])
    gen = torch.Generator(device=CPU).manual_seed(0)

    dead: set[tuple[int, int]] = set()
    dead_refs: list = []  # strong refs so CPython can't recycle the ids
    calls = []

    def tracking_decode(cfg, params, carry, *a, **kw):
        leaves = list(_tensor_leaves(carry))
        keys = {(id(leaf), leaf._version) for leaf in leaves}
        assert not (keys & dead), \
            "use-after-donate: a carry leaf was passed to decode_chunk twice"
        out = decode_chunk(cfg, params, carry, *a, **kw)
        dead.update(keys)
        dead_refs.extend(leaves)
        calls.append(a[1])  # the chunk length
        return out

    out = tlb.stream_decode_bench(cfg, params, prompt, 4, sc, 24, gen,
                                  prefill_fn=prefill, decode_fn=tracking_decode)
    assert out["n_stream"] >= 24
    assert out["first_tok_s"] is not None
    assert out["prefill_s"] > 0 and out["stream_s"] > 0
    # Two warmup chunks, then the 4-token ramp and 16-token chunks to 24.
    assert calls == [16, 4, 4, 16, 16]

    # The tracker catches a second use of a spent carry.
    carry = prefill(cfg, params, prompt, 4, sc)
    tracking_decode(cfg, params, carry, sc, 2, gen, eos_id=-1)
    with pytest.raises(AssertionError, match="use-after-donate"):
        tracking_decode(cfg, params, carry, sc, 2, gen, eos_id=-1)


def test_llm_bench_main_prints_memex_tpus_keys(capsys):
    from memex_tpu.llm.local import model as jm

    rc = tlb.main(["--geometry", "tiny", "--device", "cpu", "--prompt-len", "16",
                   "--max-new", "20"])
    assert rc == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(row) == LLM_BENCH_KEYS
    assert row["backend"] == "cpu" and row["geometry"] == "tiny"
    assert (row["prompt_len"], row["max_new"], row["param_dtype"]) == (16, 20, "bfloat16")
    assert tlb.GEOMETRIES == jlb.GEOMETRIES
    jparams = jm.convert_params(jm.init_params(jm.LlamaConfig(**tlb.GEOMETRIES["tiny"]),
                                               seed=0), "bfloat16")
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jparams))
    assert row["params_m"] == round(n / 1e6, 1)


def test_native_hnsw_library_is_shared():
    """Both packages load the one library the graph files come from."""
    from memex_tpu import native_lib as jnl
    from memex_tpu_torch import native_lib as tnl

    assert isinstance(tnl.hnsw_lib(), ctypes.CDLL)
    assert tnl._BUILD_DIR == jnl._BUILD_DIR
