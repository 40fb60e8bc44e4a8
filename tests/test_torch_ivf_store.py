"""The port's IVF store (`tpu+ivf://`, memex_tpu_torch/store/ivf_store.py)
on the CPU: the registry builds it, it matches memex_tpu's TpuIVFStore
through ingest, inline rebuild, lazy calibration and delete churn, the
TorchRuntime wires its maintenance to the worker queue (one Maintain task
for a spill-growth trigger, which the worker then runs), and the search
batcher warms it at every Q bucket."""

import numpy as np
import pytest
import torch

from memex_tpu.config import Settings
from memex_tpu.db import queue
from memex_tpu.store.base import VectorData
from memex_tpu.store.tpu_store import TpuIVFStore as JaxIVFStore
from memex_tpu.worker import Worker
from memex_tpu_torch.runtime import TorchRuntime
from memex_tpu_torch.store import registry
from memex_tpu_torch.store.ivf_store import TpuIVFStore

torch.set_num_threads(2)

D = 32
# Same float32 scores summed in a different order, plus q . mean.
SCORE_ATOL = 1e-5


def _rows(n: int, seed: int = 0, start: int = 0) -> list[VectorData]:
    rng = np.random.default_rng(seed)
    topics = rng.standard_normal((6, D)).astype(np.float32)
    v = topics[rng.integers(0, 6, n)] + 0.4 * rng.standard_normal((n, D)).astype(np.float32)
    return [VectorData(id=f"r{start + i}", document_id=f"d{(start + i) // 3}", text="",
                       vector=v[i]) for i in range(n)]


def _ingest(store, rows, batch=100):
    for i in range(0, len(rows), batch):
        store.add_vectors(rows[i : i + batch])


def _same(a, b):
    for ha, hb in zip(a, b, strict=True):
        assert [h.id for h in ha] == [h.id for h in hb]
        assert [h.document_id for h in ha] == [h.document_id for h in hb]
        np.testing.assert_allclose([h.score for h in ha], [h.score for h in hb], rtol=0,
                                   atol=SCORE_ATOL)


def test_registry_builds_the_ivf_store(tmp_path):
    store = registry.get_vector_storage(
        f"tpu+ivf://{tmp_path}/v?n_clusters=8&nprobe=2&dtype=int8&scan_int4=true"
        "&prune_target=0.9&bucket_factor=1.5", "c", dim=D, device="cpu")
    assert isinstance(store, TpuIVFStore)
    ix = store.index
    assert (ix.C, ix.nprobe, ix.dtype, ix.scan_int4, ix.bucket_factor) == (8, 2, "int8", True, 1.5)
    assert store._prune_target == 0.9 and store.count == 0 and not store.needs_recovery


@pytest.mark.parametrize("opts", [dict(dtype="int8"), dict(dtype="float32", prune_target=0.9)],
                         ids=["int8", "float32-prune_target"])
def test_store_matches_jax_through_inline_rebuilds(opts, monkeypatch):
    """Standalone stores (no scheduler) rebuild inline when the spill
    passes 20% of > 1024 rows; lazy calibration and the delete-churn
    rebuild follow memex_tpu's."""
    import jax

    import memex_tpu_torch.index.ivf as tivf

    fit = tivf.kmeans_fit

    def jax_init(v, c, iters=10, seed=0, **kw):
        n = v.shape[0]
        init = np.array(jax.random.choice(jax.random.PRNGKey(seed), n, (c,), replace=n < c))
        return fit(v, c, iters, seed, init=torch.from_numpy(init))

    monkeypatch.setattr(tivf, "kmeans_fit", jax_init)
    kw = dict(n_clusters=8, nprobe=3, **opts)
    js = JaxIVFStore(None, "c", dim=D, **kw)
    ts = TpuIVFStore(None, "c", dim=D, device="cpu", **kw)
    rows = _rows(1500)
    for st in (js, ts):
        _ingest(st, rows)
    assert ts.index.data is not None and ts.count == js.count == 1500
    assert ts.index.spill.count == js.index.spill.count
    q = np.stack([r.vector for r in rows[:7]])
    _same(js.search_batch(q, 10), ts.search_batch(q, 10))
    assert ts.index.prune_margin == js.index.prune_margin
    gone = [f"r{i}" for i in range(0, 1200, 3)]  # 400 tombstones > 25%: rebuild
    for st in (js, ts):
        assert st.delete(gone) == len(gone)
    assert not ts.index._deleted and ts.count == js.count == 1100
    _same(js.search_batch(q, 10), ts.search_batch(q, 10))


def _runtime(tmp_path, query="?n_clusters=4&nprobe=2"):
    s = Settings.from_env(db_uri=f"sqlite://{tmp_path}/t.db",
                          vector_uri=f"tpu+ivf://{tmp_path}/vec{query}")
    s.embedding_dim = D
    return TorchRuntime(s, device="cpu")


def _maintain_tasks(rt):
    rows = rt.db.query("SELECT status FROM queue WHERE task_type = ?",
                       (queue.TaskType.Maintain.value,))
    return [r["status"] for r in rows]


def test_runtime_wires_maintenance_and_the_worker_retrains(tmp_path):
    rt = _runtime(tmp_path)
    store = rt.store("c")
    assert store.on_maintenance == rt._enqueue_maintenance
    rows = _rows(1100)
    _ingest(store, rows)
    # Every batch past the threshold asked; the queue holds one task, and
    # the index did not train inline.
    assert _maintain_tasks(rt) == ["Queued"]
    assert store.index.data is None and store.index.spill.count == 1100
    assert Worker(rt, poll_interval=0.01).drain(timeout=120)
    assert _maintain_tasks(rt) == ["Completed"]
    assert store.index.data is not None and store.index.spill.count == 0
    hits = store.search_batch(np.stack([r.vector for r in rows[:4]]), 3)
    assert [h[0].id for h in hits] == [f"r{i}" for i in range(4)]
    rt.search_batcher.close()


def test_batcher_warms_an_ivf_store_at_every_q_bucket(tmp_path, monkeypatch):
    from memex_tpu_torch.serve.query_path import _Q_BUCKETS, _bucket

    rt = _runtime(tmp_path)
    store = rt.store("c")
    try:
        assert rt.search_batcher.warmup("c") == 0  # empty: nothing to warm
        store.add_vectors(_rows(50))
        seen = []
        real = store.search_batch
        monkeypatch.setattr(store, "search_batch",
                            lambda v, k: seen.append(v.shape[0]) or real(v, k))
        n = rt.search_batcher.warmup("c")
        top = _bucket(rt.settings.search_max_batch, _Q_BUCKETS)
        assert seen == [b for b in _Q_BUCKETS if b <= top] and n == len(seen)
    finally:
        rt.search_batcher.close()
