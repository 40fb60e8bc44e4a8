"""Local LLM in PyTorch: Llama- and GPT-J-family decode on the card.

Port of memex_tpu/llm/local/, which replaces the reference's GGML C
backend (lib/libmemex/src/llm/local/mod.rs) with the same capability
surface: weights from a TOML-described config (schema.rs:20-34), llama2
[INST]<<SYS>> chat assembly (mod.rs:145-170), the sampler chain
repetition-penalty/top-k/top-p/temperature (schema.rs:36-82), and the
token budget MAX_TOKENS = context - 512 - 100 (mod.rs:19). Decode keeps a
static-shape KV cache on the device and reads tokens back once a chunk.
"""

from .runtime import LocalLLM

__all__ = ["LocalLLM"]
