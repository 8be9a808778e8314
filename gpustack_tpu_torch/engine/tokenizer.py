"""Tokenizers for the engine: HF wrapper + hermetic byte-level fallback.

The byte tokenizer exists so the whole serving stack (engine, API server,
benchmark harness) runs hermetically in tests with the ``tiny`` model
configs — same doctrine as the reference's fixture-driven tests (no real
model downloads in CI, SURVEY.md §4).

The port's own copy of ``gpustack_tpu/engine/tokenizer.py``. GGUF
vocabularies are not ported yet (ROADMAP): a model directory without HF
tokenizer files gets the byte tokenizer.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence


class ByteTokenizer:
    """Lossless byte tokenizer: UTF-8 byte b -> id b+1; id 0 is EOS/pad,
    id 257 is BOS (reserved). Vocab 258."""

    vocab_size = 258
    eos_ids = (0,)

    def encode(self, text: str) -> List[int]:
        return [b + 1 for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(
            i - 1 for i in ids if 0 < i < 257
        ).decode("utf-8", errors="replace")

    def apply_chat_template(
        self, messages: List[dict], tools: Optional[List[dict]] = None,
    ) -> List[int]:
        messages = _inject_tools_fallback(messages, tools)
        text = "".join(
            f"<{m['role']}>{_content_text(m)}</{m['role']}>"
            for m in messages
        ) + "<assistant>"
        return self.encode(text)


class HFTokenizer:
    """transformers.AutoTokenizer wrapper (local files only — zero egress)."""

    def __init__(self, model_dir: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(
            model_dir, local_files_only=True
        )
        self.vocab_size = len(self._tok)
        eos = self._tok.eos_token_id
        self.eos_ids = tuple(eos if isinstance(eos, (list, tuple)) else [eos])

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=True)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def apply_chat_template(
        self, messages: List[dict], tools: Optional[List[dict]] = None,
    ) -> List[int]:
        if tools:
            # Llama-3 / Qwen / Gemma ship chat templates that render
            # function schemas natively via the ``tools=`` kwarg; fall
            # back to an injected system block for templates that don't
            # (uniform with the hermetic byte tokenizer).
            try:
                return self._tok.apply_chat_template(
                    messages, tools=tools,
                    add_generation_prompt=True, tokenize=True,
                )
            except (TypeError, ValueError, KeyError):
                messages = _inject_tools_fallback(messages, tools)
        return self._tok.apply_chat_template(
            messages, add_generation_prompt=True, tokenize=True
        )


def _content_text(message: dict) -> str:
    """Flatten OpenAI content (string or content-part list) to text."""
    content = message.get("content", "")
    if isinstance(content, list):
        return "".join(
            p.get("text", "") for p in content
            if isinstance(p, dict) and p.get("type") == "text"
        )
    return str(content or "")


def _inject_tools_fallback(
    messages: List[dict], tools: Optional[List[dict]]
) -> List[dict]:
    """Prepend a system block describing the functions (for tokenizers
    whose chat template can't take ``tools=``)."""
    if not tools:
        return messages
    from gpustack_tpu_torch.engine.openai_tools import tools_system_block

    block = tools_system_block(tools, None)
    return [{"role": "system", "content": block}] + list(messages)


def load_tokenizer(model_dir: Optional[str]):
    """HF tokenizer when a model dir with tokenizer files exists; the
    hermetic byte fallback otherwise."""
    if model_dir and os.path.isdir(model_dir) and (
        os.path.exists(os.path.join(model_dir, "tokenizer.json"))
        or os.path.exists(os.path.join(model_dir, "tokenizer_config.json"))
    ):
        return HFTokenizer(model_dir)
    return ByteTokenizer()
