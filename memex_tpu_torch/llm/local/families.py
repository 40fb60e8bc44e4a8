"""The local LLM's decoder families, under the name that `cfg.model_family`
and the TOML `[model] type` both use. A new family exports one
`model.Family` record from its module and is listed here."""

from . import deepseek_v2, gptj, model

FAMILIES = {f.name: f for f in (model.LLAMA, gptj.GPTJ, deepseek_v2.DEEPSEEK_V2)}
