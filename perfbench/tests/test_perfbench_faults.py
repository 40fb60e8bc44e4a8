"""Each cell, run at its rehearsal size on the CPU with the timed path
broken underneath, must come out `correct: false`: once with half of
each batch's answers left out, once with an answer altered where it is
produced. The fault is planted by a `sitecustomize` module on the run's
path, so it reaches the HTTP cell's server child too."""

import textwrap

import pytest

from perfbench.tests.helpers import rehearse

SEARCH = {
    "half_batch": """
        from memex_tpu_torch.serve import batcher as _b
        _orig = _b.SearchBatcher._dispatch
        def _dispatch(self, items):
            finish = _orig(self, items)
            def broken():
                res = finish()
                return res[: (len(res) + 1) // 2] + [[] for _ in res[(len(res) + 1) // 2 :]]
            return broken
        _b.SearchBatcher._dispatch = _dispatch
    """,
    "answer_altered": """
        from memex_tpu_torch.serve import batcher as _b
        from memex_tpu_torch.store.base import SearchHit
        _orig = _b.SearchBatcher._dispatch
        def _dispatch(self, items):
            finish = _orig(self, items)
            def broken():
                res = finish()
                for hits in res:
                    if hits:
                        h = hits[0]
                        other = "r%09d" % ((int(h.id[1:]) + 7777) % 8192)
                        hits[0] = SearchHit(id=other, score=h.score, document_id=h.document_id)
                return res
            return broken
        _b.SearchBatcher._dispatch = _dispatch
    """,
}
INGEST = {
    "half_batch": """
        from memex_tpu_torch import runtime as _r
        _orig = _r.TorchRuntime.add_vectors
        def add_vectors(self, collection, items):
            return _orig(self, collection, items[: (len(items) + 1) // 2])
        _r.TorchRuntime.add_vectors = add_vectors
    """,
    "answer_altered": """
        from memex_tpu_torch.embed import engine as _e
        _orig = _e.EmbeddingEngine.encode_many
        def encode_many(self, texts):
            out = _orig(self, texts)
            for segs, vecs in out:
                vecs[0, :8] = -vecs[0, :8]
            return out
        _e.EmbeddingEngine.encode_many = encode_many
    """,
}
CASES = ([(c, f, SEARCH[f]) for c in ("ivf10m_search_sat", "flat1m_http_steady")
          for f in SEARCH]
         + [("flat1m_ingest", f, INGEST[f]) for f in INGEST])


@pytest.mark.parametrize("cell,fault,patch", CASES, ids=[f"{c}-{f}" for c, f, _ in CASES])
def test_fault_is_not_correct(cell, fault, patch, tmp_path):
    (tmp_path / "sitecustomize.py").write_text(textwrap.dedent(patch))
    rc, line, err = rehearse(cell, pythonpath=[str(tmp_path)], seconds=3.0)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]
