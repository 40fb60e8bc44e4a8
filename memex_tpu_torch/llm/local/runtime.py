"""LocalLLM: the LLM-protocol wrapper around the PyTorch decoders (port of
memex_tpu/llm/local/runtime.py).

Reference surface (lib/libmemex/src/llm/local/mod.rs):
  - TOML config describing model + sampler (load_from_cfg :208-258,
    schema.rs:20-105)
  - llama2 chat assembly "[INST] <<SYS>> ... [/INST]" (:145-170)
  - MAX_TOKENS = context - 512 - 100 budget (:19)
  - streaming token events (:55-137) -> on_token callback here.

Tokenizer: HF tokenizer files in the model dir when present (via
`transformers`), else a hermetic byte-level tokenizer (ids 0-255 +
BOS/EOS) so the whole stack runs with zero downloads.

The model lives on one torch device (the card unless the caller passes
`device="cpu"`); sampling draws from a torch.Generator there, seeded by
`seed`.
"""

from __future__ import annotations

import json
import os
import time
import tomllib

import torch

from ...log import get_logger
from ...metrics import METRICS
from ...text.segment import count_tokens
from ..base import ChatMessage, budget_segment, budget_truncate
from .model import (
    LlamaConfig,
    SamplerConfig,
    convert_params,
    decode_chunk,
    generate,
    init_params,
    load_params,
    prefill,
)

logger = get_logger(__name__)

RESPONSE_BUDGET = 512   # reference MAX_TOKENS parts (local/mod.rs:19)
PROMPT_OVERHEAD = 100
_PROMPT_BUCKETS = (64, 128, 256, 512, 1024, 2048)


def prompt_buckets(max_context: int) -> tuple[int, ...]:
    """The padded prompt lengths below max_context - RESPONSE_BUDGET (the
    longest prompt kept, which is the last bucket): _PROMPT_BUCKETS, then
    powers of two."""
    top = max_context - RESPONSE_BUDGET
    out = [b for b in _PROMPT_BUCKETS if b < max_context]
    b = 2 * _PROMPT_BUCKETS[-1]
    while b < top:
        out.append(b)
        b *= 2
    return tuple(out)


class ByteTokenizer:
    """Hermetic fallback: bytes -> ids (+BOS=256, EOS=257)."""

    vocab_size = 258
    bos_id = 256
    eos_id = 257

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8", errors="replace"))

    def decode(self, ids: list[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")


class HFTokenizer:
    def __init__(self, model_dir: str):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(model_dir, local_files_only=True)
        self.bos_id = self.tok.bos_token_id or 1
        self.eos_id = self.tok.eos_token_id or 2
        self.vocab_size = self.tok.vocab_size

    def encode(self, text: str) -> list[int]:
        return self.tok.encode(text, add_special_tokens=False)

    def decode(self, ids: list[int]) -> str:
        return self.tok.decode(ids, skip_special_tokens=True)


def render_chat(messages: list[ChatMessage]) -> str:
    """llama2-style chat assembly (reference local/mod.rs:145-170)."""
    system = ""
    turns: list[tuple[str, str]] = []
    for m in messages:
        if m.role.value == "system":
            system = m.content
        else:
            turns.append((m.role.value, m.content))
    parts = []
    first_user = True
    for role, content in turns:
        if role == "user":
            if first_user and system:
                parts.append(f"[INST] <<SYS>>\n{system}\n<</SYS>>\n\n{content} [/INST]")
                first_user = False
            else:
                parts.append(f"[INST] {content} [/INST]")
        else:
            parts.append(f" {content} ")
    return "".join(parts)


def _tree_to(params: dict, device: torch.device) -> dict:
    return {k: (_tree_to(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in params.items()}


class LocalLLM:
    def __init__(self, cfg: LlamaConfig, params: dict, tokenizer,
                 sampler: SamplerConfig | None = None, model_name: str = "local-llama",
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = _tree_to(params, self.device)
        self.tokenizer = tokenizer
        self.sampler = sampler or SamplerConfig()
        self._model_name = model_name
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.max_tokens = cfg.max_context - RESPONSE_BUDGET - PROMPT_OVERHEAD
        # The last stream's ids and when its first id reached the host
        # (time.perf_counter()), for a caller timing its first token.
        self.last_stream = {"ids": 0, "first_id_at": None}
        # The last completion's prompt length and emitted ids, either path.
        self.last_completion = {"prompt_ids": 0, "ids": []}

    # -- construction ----------------------------------------------------------

    @classmethod
    def from_config(cls, toml_path: str, device="cuda", weights=None) -> "LocalLLM":
        """TOML config (reference schema.rs:20-34 shape):
            [model]   path = "<hf dir>" | "tiny" | "tiny-gptj"   name = "..."
                      type = "llama" | "gptj" | "deepseek_v2" (else config.json's
                             model_type, else llama)
                      param_dtype = "bfloat16" (default) | "float32" | "int8"
            deepseek_v2 only:
                      max_context = <positions> (default: min(published, 4096))
            [sampler] temperature / top_k / top_p / repetition_penalty

        `weights` (deepseek_v2 only): the checkpoint's tensors already in
        memory, anything whose get(name) gives one by its HF name, loaded
        in place of the dir's safetensors (the dir then needs only
        config.json).

        param_dtype is the weight storage dtype: decode reads every weight
        once a token, so bf16 halves its bytes against float32 and int8
        halves them again (per-out-channel scales; Llama and GPT-J only).
        A family outside the table raises ValueError. A missing model dir
        falls back to the tiny model, as memex_tpu does, except for
        deepseek_v2, which raises.
        """
        with open(toml_path, "rb") as fh:
            cfg_data = tomllib.load(fh)
        model = cfg_data.get("model", {})
        sam = cfg_data.get("sampler", {})
        sampler = SamplerConfig(
            temperature=float(sam.get("temperature", 0.7)),
            top_k=int(sam.get("top_k", 40)),
            top_p=float(sam.get("top_p", 0.95)),
            repetition_penalty=float(sam.get("repetition_penalty", 1.1)),
        )
        path = str(model.get("path", "tiny"))
        name = model.get("name", os.path.basename(path) or "local")
        have_dir = path not in ("tiny", "tiny-gptj") and os.path.isdir(path)
        family = model.get("type")
        if family is None and have_dir:
            with open(os.path.join(path, "config.json"), encoding="utf-8") as fh:
                family = json.load(fh).get("model_type")
        family = str(family or "llama").lower()  # reference schema.rs:20-34
        if family not in _FAMILIES:
            raise ValueError(f"unknown local LLM family {family!r} in {toml_path}; "
                             f"known: {sorted(_FAMILIES)}")
        if weights is not None and family != "deepseek_v2":
            raise ValueError(f"weights= is for deepseek_v2, not {family!r}")
        if not have_dir:
            if family == "deepseek_v2":
                raise ValueError(f"deepseek_v2 needs a model directory with config.json; "
                                 f"{path!r} is none")
            if path not in ("tiny", "tiny-gptj"):
                logger.warning("model dir %s missing; using tiny hermetic model", path)
            if family == "gptj" or path == "tiny-gptj":
                return cls.tiny_gptj(sampler=sampler, model_name=name, device=device)
            return cls.tiny(sampler=sampler, model_name=name, device=device)
        cfg, params = _FAMILIES[family](path, model, device, weights)
        tokenizer = (
            HFTokenizer(path)
            if os.path.exists(os.path.join(path, "tokenizer.json"))
            or os.path.exists(os.path.join(path, "tokenizer.model"))
            else ByteTokenizer()
        )
        return cls(cfg, params, tokenizer, sampler, model_name=name, device=device)

    @classmethod
    def tiny(cls, sampler: SamplerConfig | None = None, seed: int = 0,
             model_name: str = "tiny-llama", device="cuda") -> "LocalLLM":
        cfg = LlamaConfig.tiny(vocab_size=ByteTokenizer.vocab_size)
        return cls(cfg, init_params(cfg, seed=seed, device=device), ByteTokenizer(), sampler,
                   model_name=model_name, seed=seed, device=device)

    @classmethod
    def tiny_gptj(cls, sampler: SamplerConfig | None = None, seed: int = 0,
                  model_name: str = "tiny-gptj", device="cuda") -> "LocalLLM":
        from .gptj import GptJConfig, init_params as gptj_init

        cfg = GptJConfig.tiny(vocab_size=ByteTokenizer.vocab_size)
        return cls(cfg, gptj_init(cfg, seed=seed, device=device), ByteTokenizer(), sampler,
                   model_name=model_name, seed=seed, device=device)

    # -- LLM protocol ------------------------------------------------------------

    @property
    def default_model(self) -> str:
        return self._model_name

    def encode_prompt(self, messages: list[ChatMessage],
                      max_new: int | None) -> tuple[torch.Tensor, int, int]:
        """(padded prompt [1, bucket] on the device, prompt length, max_new)."""
        prompt_text = render_chat(messages)
        ids = [self.tokenizer.bos_id] + self.tokenizer.encode(prompt_text)
        max_prompt = self.cfg.max_context - RESPONSE_BUDGET
        ids = ids[-max_prompt:]
        # bucket the prompt length to bound the shapes a forward sees
        bucket = next((b for b in prompt_buckets(self.cfg.max_context) if len(ids) <= b),
                      max_prompt)
        padded = torch.zeros((1, bucket), dtype=torch.long)
        padded[0, : len(ids)] = torch.tensor(ids, dtype=torch.long)
        max_new = min(max_new or RESPONSE_BUDGET, self.cfg.max_context - bucket - 1)
        if max_new <= 0:
            raise ValueError("prompt fills the context window")
        return padded.to(self.device), len(ids), max_new

    def chat_completion(self, model: str, messages: list[ChatMessage],
                        on_token=None, max_new: int | None = None) -> str:
        padded, n_ids, max_new = self.encode_prompt(messages, max_new)
        METRICS.inc("llm.prompt_tokens", n_ids)
        with METRICS.device_timing() as timing:
            if on_token is None:
                # Batch path: the whole generation, then one host read.
                tokens, n_valid = generate(
                    self.cfg, self.params, padded, n_ids, self.sampler, max_new, self._gen,
                    eos_id=self.tokenizer.eos_id,
                )
                host = torch.cat([tokens, n_valid.view(1)]).tolist()
                out = host[: host[-1]]
            else:
                # Streaming path: STREAM_CHUNK tokens a call; the KV cache
                # stays on the device, and on_token fires while generation
                # continues (the reference streams token events the same
                # way, local/mod.rs:101-126).
                out = self._stream(padded, n_ids, max_new, on_token)
        timing.count()  # after the read: the device has passed every span counted
        self.last_completion = {"prompt_ids": n_ids, "ids": [int(t) for t in out]}
        return self.tokenizer.decode([int(t) for t in out])

    STREAM_CHUNK = 16  # steady-state tokens a call
    # The first call is short: the first visible token waits for prefill,
    # the first chunk and one read, so a 16-token first chunk buries the
    # first word under ~12 tokens of extra decode.
    FIRST_CHUNK = 4

    def _enqueue(self, carry, chunk: int):
        """Enqueue `chunk` decode steps and the copy of their tokens and
        done flags to the host. On a card the copy lands in pinned memory
        behind an event, so waiting for this chunk does not wait for a
        chunk enqueued after it (`.cpu()` would wait for everything
        enqueued)."""
        with METRICS.span("llm.decode"), METRICS.device_span(
                "llm.decode_dev", self.device, {"llm.decode_tokens": chunk}):
            carry, toks, was_done = decode_chunk(
                self.cfg, self.params, carry, self.sampler, chunk, self._gen,
                eos_id=self.tokenizer.eos_id,
            )
        both = torch.stack([toks, was_done.to(toks.dtype)])
        if self.device.type != "cuda":
            return carry, both, None
        host = torch.empty(both.shape, dtype=both.dtype, pin_memory=True)
        host.copy_(both, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return carry, host, ready

    def _stream(self, padded, n_ids, max_new, on_token) -> list[int]:
        eos = self.tokenizer.eos_id
        with METRICS.span("llm.prefill"), METRICS.device_span("llm.prefill_dev", self.device):
            carry = prefill(self.cfg, self.params, padded, n_ids, self.sampler)
        out: list[int] = []
        self.last_stream = {"ids": 0, "first_id_at": None}
        # Incremental detokenization over a bounded tail window (the
        # HF/vLLM detokenize_incrementally scheme): decoding the full
        # sequence per token is O(n^2) tokenizer work. `prefix_off`
        # anchors the window at the last emitted token (its presence gives
        # SentencePiece the space/byte context the next tokens need);
        # `read_off` marks how many tokens have surfaced. Both decodes
        # below start at prefix_off, so any boundary artifact cancels in
        # the delta. A trailing replacement char means a multi-byte
        # sequence is still incomplete: hold it back.
        prefix_off = 0
        read_off = 0
        done = False
        # One-chunk lookahead: chunk i+1 is enqueued before chunk i's
        # tokens are read, so the card decodes while the host detokenizes.
        # An eos inside chunk i wastes chunk i+1's speculative tokens; the
        # carry is discarded.
        pending = self._enqueue(carry, self.FIRST_CHUNK)
        dispatched = self.FIRST_CHUNK  # tokens covered by enqueued chunks
        while not done and len(out) < max_new:
            carry, host, ready = pending
            if dispatched < max_new:
                pending = self._enqueue(carry, self.STREAM_CHUNK)
                dispatched += self.STREAM_CHUNK
            if ready is not None:
                ready.synchronize()
            toks, wd = host.tolist()
            for t, d in zip(toks, wd):
                if d or len(out) >= max_new:
                    done = True
                    break
                out.append(int(t))
                if len(out) == 1:
                    self.last_stream["first_id_at"] = time.perf_counter()
                prefix_text = self.tokenizer.decode(out[prefix_off:read_off])
                new_text = self.tokenizer.decode(out[prefix_off:])
                if (not new_text.endswith("\ufffd")
                        and len(new_text) > len(prefix_text)):
                    on_token(new_text[len(prefix_text):])
                    prefix_off = read_off
                    read_off = len(out)
                if int(t) == eos:
                    done = True
                    break
        # Flush any held-back tail (incomplete byte sequences included).
        prefix_text = self.tokenizer.decode(out[prefix_off:read_off])
        tail = self.tokenizer.decode(out[prefix_off:])
        if len(tail) > len(prefix_text):
            on_token(tail[len(prefix_text):])
        self.last_stream["ids"] = len(out)
        return out

    def segment_text(self, text: str) -> tuple[list[str], str]:
        if count_tokens(text) <= self.max_tokens:
            return [text], self._model_name
        return budget_segment(text, self.max_tokens), self._model_name

    def truncate_text(self, text: str) -> tuple[str, str]:
        return budget_truncate(text, self.max_tokens), self._model_name


# -- families ------------------------------------------------------------------


def _load_llama(path: str, model: dict, device, weights=None) -> tuple:
    cfg, params = load_params(path, device=device)
    return cfg, convert_params(params, str(model.get("param_dtype", "bfloat16")))


def _load_gptj(path: str, model: dict, device, weights=None) -> tuple:
    from .gptj import load_params as gptj_load

    cfg, params = gptj_load(path, device=device)
    return cfg, convert_params(params, str(model.get("param_dtype", "bfloat16")))


def _load_deepseek_v2(path: str, model: dict, device, weights=None) -> tuple:
    """Weights land in param_dtype as they are read (the float32
    copy of a 15.7B model would not fit on the card); the compute dtype
    follows it."""
    from . import deepseek_v2 as ds

    dtype = str(model.get("param_dtype", "bfloat16"))
    if dtype not in ("bfloat16", "float32"):
        raise ValueError(f"deepseek_v2: param_dtype {dtype!r} is not supported "
                         "(bfloat16 or float32)")
    cfg = ds.DeepseekV2Config.from_model_dir(path, model.get("max_context"), dtype)
    return ds.load_params(path, cfg, device=device, dtype=dtype, tensors=weights)


# model family -> (model dir, TOML [model] table, device, weights) -> (cfg, params)
_FAMILIES = {"llama": _load_llama, "gptj": _load_gptj, "deepseek_v2": _load_deepseek_v2}
