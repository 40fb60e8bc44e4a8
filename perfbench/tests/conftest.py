"""The every-cell control test (`test_perfbench_control.py`) calls
`control.search_control` for every traffic kind but `ingest_backlog`;
`control.py` knows no LLM cell. For traffic kind `llm_ask` the call is
routed here to that cell's own control (`control_llm`, the top-5 router),
so the test holds the LLM cell to the same verdict as the others. Folding
`control_llm` into `control.py`'s choice by kind takes this away."""

from perfbench import control as _control
from perfbench import control_llm

_search_control = _control.search_control


def _search_or_llm_control(ctx) -> dict:
    if ctx.traffic["kind"] == "llm_ask":
        return control_llm.control(ctx, "top5")
    return _search_control(ctx)


_control.search_control = _search_or_llm_control
