"""OpenAI surface helpers: tool calling, JSON mode, logprob shaping.

The port's own copy of ``gpustack_tpu/engine/openai_tools.py`` (pure
Python; the port imports nothing of the JAX package).

The reference proxies vLLM/SGLang's full OpenAI surface
(gpustack/routes/openai.py:185-313 relays tools/logprobs/n/response_format
to the backend engines); here the in-repo engine implements the same
semantics natively:

- **Tool calling** is template-driven. HF chat templates for the served
  families (Llama-3, Qwen, Gemma via their tokenizer_config) accept a
  ``tools=`` kwarg and render the function schemas into the prompt; for
  tokenizers without native template support an equivalent system block
  is injected. Model output is parsed for Hermes/Qwen-style
  ``<tool_call>{...}</tool_call>`` blocks and Llama-3-style bare JSON
  ``{"name": ..., "parameters": ...}`` calls.
- **JSON mode** (``response_format={"type": "json_object"}``): a
  JSON-aware instruction is injected and :class:`JsonScanner` tracks the
  decoded stream, finishing the request the moment one complete
  top-level JSON value closes — no trailing garbage.
"""

from __future__ import annotations

import json
import re
import uuid
from typing import Any, Dict, List, Optional, Tuple

TOOL_CALL_OPEN = "<tool_call>"
TOOL_CALL_CLOSE = "</tool_call>"

JSON_MODE_INSTRUCTION = (
    "You must answer with a single valid JSON object and nothing else — "
    "no prose, no markdown fences."
)


def tools_system_block(
    tools: List[Dict[str, Any]], tool_choice: Any
) -> str:
    """System-prompt block describing the available functions (the
    fallback rendering when the tokenizer's chat template can't take
    ``tools=`` natively; mirrors the Hermes/Qwen convention so the parse
    side is uniform across families)."""
    lines = [
        "You have access to the following functions. To call a function, "
        "respond with a <tool_call> block containing a JSON object with "
        '"name" and "arguments" keys, e.g. '
        '<tool_call>{"name": "fn", "arguments": {"x": 1}}</tool_call>.',
        "",
        "Available functions:",
    ]
    for t in tools:
        fn = t.get("function", t)
        lines.append(json.dumps({
            "name": fn.get("name", ""),
            "description": fn.get("description", ""),
            "parameters": fn.get("parameters", {}),
        }))
    forced = forced_function(tool_choice)
    if forced:
        lines.append(f'You MUST call the function "{forced}".')
    elif tool_choice == "required":
        lines.append("You MUST call one of the functions.")
    return "\n".join(lines)


def forced_function(tool_choice: Any) -> Optional[str]:
    """The function name a ``tool_choice`` object forces, if any."""
    if isinstance(tool_choice, dict):
        return tool_choice.get("function", {}).get("name") or None
    return None


_BARE_JSON_CALL = re.compile(r"^\s*\{", re.DOTALL)


def parse_tool_calls(
    text: str,
) -> Tuple[str, List[Dict[str, Any]]]:
    """Split generated text into (content, tool_calls).

    Recognizes ``<tool_call>{...}</tool_call>`` blocks anywhere in the
    text (Hermes/Qwen convention, which the injected system block also
    teaches) and — when the whole completion is one bare JSON object with
    a ``name`` and ``arguments``/``parameters`` — the Llama-3 style call.
    Returns OpenAI-shaped tool_call dicts with generated ids.
    """
    calls: List[Dict[str, Any]] = []
    content_parts: List[str] = []
    pos = 0
    while True:
        start = text.find(TOOL_CALL_OPEN, pos)
        if start == -1:
            content_parts.append(text[pos:])
            break
        content_parts.append(text[pos:start])
        end = text.find(TOOL_CALL_CLOSE, start)
        body = (
            text[start + len(TOOL_CALL_OPEN):end] if end != -1
            else text[start + len(TOOL_CALL_OPEN):]
        )
        call = _call_from_json(body)
        if call:
            calls.append(call)
        else:
            # unparseable block: surface it as content, don't drop it
            content_parts.append(text[start:end if end != -1 else len(text)])
        if end == -1:
            break
        pos = end + len(TOOL_CALL_CLOSE)
    content = "".join(content_parts).strip()
    if not calls and _BARE_JSON_CALL.match(text or ""):
        # Llama-3 bare-JSON form: require an explicit arguments/
        # parameters key — any JSON answer that merely CONTAINS a
        # "name" field (e.g. a person record) must stay content.
        call = _call_from_json(text, require_args=True)
        if call:
            return "", [call]
    return content, calls


def _call_from_json(
    body: str, require_args: bool = False
) -> Optional[Dict[str, Any]]:
    try:
        obj = json.loads(body.strip())
    except json.JSONDecodeError:
        return None
    if not isinstance(obj, dict) or not obj.get("name"):
        return None
    if require_args and "arguments" not in obj and "parameters" not in obj:
        return None
    args = obj.get("arguments", obj.get("parameters", {}))
    if not isinstance(args, (dict, list, str)):
        return None
    return {
        "id": f"call_{uuid.uuid4().hex[:24]}",
        "type": "function",
        "function": {
            "name": str(obj["name"]),
            "arguments": (
                args if isinstance(args, str)
                else json.dumps(args)
            ),
        },
    }


class JsonScanner:
    """Incremental detector for the end of one top-level JSON value.

    Feed decoded text chars; :meth:`feed` returns the index (relative to
    the fed chunk) ONE PAST the char that completes the first top-level
    JSON value, or -1 while incomplete. Leading non-JSON chars before the
    value starts are tolerated (models sometimes emit whitespace first).
    Only object/array roots are tracked — a bare scalar root has no
    unambiguous end in a stream.
    """

    def __init__(self) -> None:
        self.depth = 0
        self.started = False
        self.in_string = False
        self.escape = False

    def feed(self, chunk: str) -> int:
        for i, ch in enumerate(chunk):
            if not self.started:
                if ch in "{[":
                    self.started = True
                    self.depth = 1
                continue
            if self.in_string:
                if self.escape:
                    self.escape = False
                elif ch == "\\":
                    self.escape = True
                elif ch == '"':
                    self.in_string = False
                continue
            if ch == '"':
                self.in_string = True
            elif ch in "{[":
                self.depth += 1
            elif ch in "}]":
                self.depth -= 1
                if self.depth == 0:
                    return i + 1
        return -1


class ToolCallHoldback:
    """Streaming filter that withholds text which may be the start of a
    ``<tool_call>`` block. Pass each outgoing piece through
    :meth:`filter`; once a block opens, everything is buffered (the
    caller emits parsed tool_call deltas at finish instead). ``flush()``
    releases a dangling partial marker that never completed."""

    def __init__(self) -> None:
        self.pending = ""
        self.in_call = False

    def filter(self, piece: str) -> str:
        if self.in_call:
            self.pending += piece
            return ""
        text = self.pending + piece
        start = text.find(TOOL_CALL_OPEN)
        if start != -1:
            self.in_call = True
            self.pending = text[start:]
            return text[:start]
        # hold back any suffix that is a prefix of the open marker
        hold = 0
        for k in range(min(len(TOOL_CALL_OPEN) - 1, len(text)), 0, -1):
            if text.endswith(TOOL_CALL_OPEN[:k]):
                hold = k
                break
        self.pending = text[len(text) - hold:] if hold else ""
        return text[: len(text) - hold] if hold else text

    def flush(self) -> str:
        """Text still held that turned out not to be a tool call."""
        if self.in_call:
            return ""
        out, self.pending = self.pending, ""
        return out
