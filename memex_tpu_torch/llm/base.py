"""LLM protocol, chat types, and client selection.

Reference: trait LLM {chat_completion, segment_text, truncate_text} and
ChatMessage/ChatRole/LLMError (lib/libmemex/src/llm/mod.rs:11-74); client
selection order in api::start (lib/api/src/lib.rs:94-103): OpenAI key ->
OpenAI, else local config -> local model.
"""

from __future__ import annotations

import enum
import os
from dataclasses import dataclass
from typing import Protocol, runtime_checkable

from ..config import Settings
from ..text.segment import count_tokens, split_text


class ChatRole(str, enum.Enum):
    System = "system"
    User = "user"
    Assistant = "assistant"


@dataclass
class ChatMessage:
    role: ChatRole
    content: str

    def as_dict(self) -> dict:
        return {"role": self.role.value, "content": self.content}


class LLMError(Exception):
    pass


class ContextLengthExceeded(LLMError):
    pass


class InferenceError(LLMError):
    pass


@runtime_checkable
class LLM(Protocol):
    def chat_completion(self, model: str, messages: list[ChatMessage]) -> str: ...

    def segment_text(self, text: str) -> tuple[list[str], str]:
        """Split text into model-budget-sized chunks; returns (chunks, model)
        (reference llm/mod.rs:70-73)."""
        ...

    def truncate_text(self, text: str) -> tuple[str, str]:
        """Fit text into the largest available context; returns
        (possibly-truncated text, model) (llm/mod.rs:74)."""
        ...

    @property
    def default_model(self) -> str: ...


def budget_segment(text: str, max_tokens: int) -> list[str]:
    """Shared chunking helper: word-level splitter budgeted by token count
    (reference split_text, llm/mod.rs:76-117)."""
    return split_text(text, max_tokens, counter=count_tokens)


def budget_truncate(text: str, max_tokens: int) -> str:
    """Truncate to approximately max_tokens (reference local truncate,
    llm/local/mod.rs:185-205)."""
    if count_tokens(text) <= max_tokens:
        return text
    words = text.split(" ")
    lo, hi = 0, len(words)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if count_tokens(" ".join(words[:mid])) <= max_tokens:
            lo = mid
        else:
            hi = mid - 1
    return " ".join(words[:lo])


def get_llm(settings: Settings | None = None, device="cuda") -> LLM:
    """Client selection (reference lib/api/src/lib.rs:94-103):
    MEMEX_FAKE_LLM=1 -> deterministic fake (hermetic envs);
    OPENAI_API_KEY -> OpenAI client;
    LOCAL_LLM_CONFIG -> the local PyTorch model on `device`;
    else -> fake with a warning.
    """
    settings = settings or Settings.from_env()
    if os.environ.get("MEMEX_FAKE_LLM"):
        from .fake import FakeLLM

        return FakeLLM()
    if settings.openai_api_key:
        from .openai_client import OpenAIClient

        return OpenAIClient(settings.openai_api_key, base_url=settings.openai_base_url)
    if settings.local_llm_config:
        from .local import LocalLLM

        return LocalLLM.from_config(settings.local_llm_config, device=device)
    from ..log import get_logger

    get_logger(__name__).warning(
        "no LLM configured (OPENAI_API_KEY / LOCAL_LLM_CONFIG); using FakeLLM"
    )
    from .fake import FakeLLM

    return FakeLLM()
