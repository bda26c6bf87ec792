"""Guided (constrained) decoding: JSON mode.

``response_format: {"type": "json_object"}`` means every sampled token must
keep the output a prefix of some valid JSON document.  The reference stack
delegates this to its engines (vLLM guided decoding); here the engine is
native, so the constraint machinery is too — designed for the TPU execution
model:

- **All vocab-sized work happens once, off the hot path.**  A char-level
  JSON automaton is compiled against the tokenizer into a boolean mask
  table ``[num_modes, vocab]`` (``JsonTokenMasks.build``): row m = the
  tokens admissible in automaton mode m.  The table is uploaded to the
  device once.
- **Per step, the host sends one int per lane.**  The engine's decode jit
  indexes the resident table with each lane's mode id and masks logits to
  -inf before sampling (engine/engine.py); lanes with mode -1 are
  unguided.  No per-step vocab-sized host↔device traffic.
- **The host advances the real automaton between steps** (``JsonCursor``):
  it tracks the full container stack, so nesting is unbounded even though
  the mask table is finite.

Finite-mode trick: a mask row cannot depend on the unbounded stack, so
modes are (char-state × top-of-stack-container) pairs.  Tokens whose
characters would pop PAST the current container (e.g. ``"}]}``) are
conservatively masked unless everything after the pop is whitespace —
single-char structural tokens always exist in practice, so generation
never wedges; the host cursor, which knows the whole stack, then computes
the true next mode.  Same trick for strings: special tokens (``<|eos|>``
and friends) are never admissible inside a document — their markup chars
would otherwise be legal STRING content — and become admissible only in
the terminal mode, so the model can stop.

Token strings come from per-id ``decode``; byte-fallback tokens that
decode to replacement chars are masked (conservative: the bytes may split
a UTF-8 sequence across tokens, which this char-level automaton cannot
validate).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
from dynamo_tpu_torch.utils import knobs

WS = " \t\n\r"
DIGITS = "0123456789"
HEX = "0123456789abcdefABCDEF"
# chars banned inside JSON strings (control chars); '"' and '\\' handled
_CTRL = {chr(c) for c in range(0x20)}

# (kind, extra) char-level states.  Container context is threaded
# separately; see _step_char.
_LIT_SUFFIXES = ("rue", "ue", "e", "alse", "lse", "se", "ull", "ll", "l")
_NUM_SUBS = ("sign", "zero", "int", "dot", "frac", "e", "esign", "exp")

# number sub-states from which the number is already a complete value
# (a terminator char or end-of-token is legal there)
_NUM_TERMINAL = {"zero", "int", "frac", "exp"}


class _Pop(Exception):
    """Internal signal: the char closed the current container."""


class _Bad(Exception):
    """Internal signal: the char is not admissible in this state."""


def _step_char(kind: str, extra, ch: str, top: str | None):
    """One character through the automaton.

    Returns (kind', extra', action) where action is None, ("push", c), or
    ("pop",).  ``top`` is the current innermost container ("obj" | "arr" |
    None).  Raises _Bad for inadmissible chars."""
    # -- inside strings ----------------------------------------------------
    if kind in ("str", "keystr"):
        if ch == '"':
            return (("colon", None, None) if kind == "keystr"
                    else ("after", None, None))
        if ch == "\\":
            return ("esc" if kind == "str" else "keyesc", None, None)
        if ch in _CTRL:
            raise _Bad
        return (kind, None, None)
    if kind in ("esc", "keyesc"):
        target = "str" if kind == "esc" else "keystr"
        if ch in '"\\/bfnrt':
            return (target, None, None)
        if ch == "u":
            return ("stru" if kind == "esc" else "keyu", 4, None)
        raise _Bad
    if kind in ("stru", "keyu"):
        if ch not in HEX:
            raise _Bad
        if extra == 1:
            return ("str" if kind == "stru" else "keystr", None, None)
        return (kind, extra - 1, None)

    # -- literals ----------------------------------------------------------
    if kind == "lit":
        if ch != extra[0]:
            raise _Bad
        if len(extra) == 1:
            return ("after", None, None)
        return ("lit", extra[1:], None)

    # -- numbers -----------------------------------------------------------
    if kind == "num":
        sub = extra
        if sub == "sign":
            if ch == "0":
                return ("num", "zero", None)
            if ch in DIGITS:
                return ("num", "int", None)
            raise _Bad
        if sub in ("zero", "int"):
            if sub == "int" and ch in DIGITS:
                return ("num", "int", None)
            if ch == ".":
                return ("num", "dot", None)
            if ch in "eE":
                return ("num", "e", None)
            return _end_value_char(ch, top)
        if sub == "dot":
            if ch in DIGITS:
                return ("num", "frac", None)
            raise _Bad
        if sub == "frac":
            if ch in DIGITS:
                return ("num", "frac", None)
            if ch in "eE":
                return ("num", "e", None)
            return _end_value_char(ch, top)
        if sub == "e":
            if ch in "+-":
                return ("num", "esign", None)
            if ch in DIGITS:
                return ("num", "exp", None)
            raise _Bad
        if sub == "esign":
            if ch in DIGITS:
                return ("num", "exp", None)
            raise _Bad
        if sub == "exp":
            if ch in DIGITS:
                return ("num", "exp", None)
            return _end_value_char(ch, top)

    # -- structure ---------------------------------------------------------
    # "value": expecting a value (after ':' , document start, or an array
    # comma).  "arrfirst": right after '[' — a value OR an immediate ']'
    # (empty array).  Keeping these distinct is what makes trailing commas
    # ("[1,]") inadmissible: after a comma the state is plain "value",
    # which never admits a close.
    if kind in ("value", "arrfirst"):
        if ch in WS:
            return (kind, None, None)
        if ch == "]" and kind == "arrfirst" and top == "arr":
            return ("after", None, ("pop",))
        if ch == '"':
            return ("str", None, None)
        if ch == "{":
            return ("objopen", None, ("push", "obj"))
        if ch == "[":
            return ("arrfirst", None, ("push", "arr"))
        if ch == "-":
            return ("num", "sign", None)
        if ch == "0":
            return ("num", "zero", None)
        if ch in DIGITS:
            return ("num", "int", None)
        if ch == "t":
            return ("lit", "rue", None)
        if ch == "f":
            return ("lit", "alse", None)
        if ch == "n":
            return ("lit", "ull", None)
        raise _Bad
    # "objopen": right after '{' — a key or an immediate '}' (empty
    # object).  "objkey": after an object comma — a key ONLY, so "{...,}"
    # is inadmissible.
    if kind in ("objopen", "objkey"):
        if ch in WS:
            return (kind, None, None)
        if ch == '"':
            return ("keystr", None, None)
        if ch == "}" and kind == "objopen":
            return ("after", None, ("pop",))
        raise _Bad
    if kind == "colon":
        if ch in WS:
            return ("colon", None, None)
        if ch == ":":
            return ("value", None, None)
        raise _Bad
    if kind == "after":
        return _end_value_char(ch, top)
    raise AssertionError(f"unknown state {kind!r}")


def _end_value_char(ch: str, top: str | None):
    """A char arriving right after a complete value."""
    if ch in WS:
        return ("after", None, None)
    if top == "obj":
        if ch == ",":
            return ("objkey", None, None)   # a key MUST follow (no "{a:1,}")
        if ch == "}":
            return ("after", None, ("pop",))
    elif top == "arr":
        if ch == ",":
            return ("value", None, None)    # a value MUST follow (no "[1,]")
        if ch == "]":
            return ("after", None, ("pop",))
    raise _Bad


def _modes_universe() -> list[tuple[str, object, str | None]]:
    """Every (kind, extra, top) combination a mask row may be needed for."""
    kinds: list[tuple[str, object]] = [
        ("value", None), ("arrfirst", None), ("after", None),
        ("objopen", None), ("objkey", None), ("colon", None),
        ("str", None), ("esc", None), ("keystr", None), ("keyesc", None),
    ]
    kinds += [("stru", k) for k in (1, 2, 3, 4)]
    kinds += [("keyu", k) for k in (1, 2, 3, 4)]
    kinds += [("num", s) for s in _NUM_SUBS]
    kinds += [("lit", s) for s in _LIT_SUFFIXES]
    return [(k, e, top) for k, e in kinds for top in (None, "obj", "arr")]


def _token_admissible(
    text: str, kind: str, extra, top: str | None
) -> bool:
    """Simulate a whole token's chars from (kind, extra, top).

    Pushes within the token are tracked exactly (the in-token stack is
    known); a pop beyond the in-token stack leaves the surrounding
    container unknown, after which only whitespace is admissible (the
    conservative finite-mode rule from the module docstring)."""
    if not text:
        return False
    stack: list[str] = []      # containers opened inside this token
    popped_out = False          # popped past the starting container?
    for ch in text:
        if popped_out:
            if ch in WS:
                continue
            return False
        cur_top = stack[-1] if stack else top
        try:
            kind, extra, action = _step_char(kind, extra, ch, cur_top)
        except _Bad:
            return False
        if action is not None:
            if action[0] == "push":
                stack.append(action[1])
            else:  # pop
                if stack:
                    stack.pop()
                else:
                    if top is None:
                        return False  # nothing to close
                    popped_out = True
    return True


@dataclass
class JsonTokenMasks:
    """Compiled admissible-token table for one tokenizer."""

    mask: np.ndarray                 # [num_modes, vocab] bool
    mode_index: dict[tuple, int]
    eos_allowed_modes: list[int] = field(default_factory=list)

    TERMINAL = ("after", None, None)  # document complete

    @classmethod
    def build(
        cls,
        token_strings: list[str],
        *,
        special_ids: set[int] | frozenset[int] = frozenset(),
        eos_ids: list[int] | None = None,
    ) -> "JsonTokenMasks":
        modes = _modes_universe()
        vocab = len(token_strings)
        mask = np.zeros((len(modes), vocab), bool)
        specials = set(special_ids)
        clean: list[str | None] = []
        for tid, text in enumerate(token_strings):
            if tid in specials or not text or "�" in text:
                clean.append(None)  # never admissible inside a document
            else:
                clean.append(text)
        for m, (kind, extra, top) in enumerate(modes):
            row = mask[m]
            for tid, text in enumerate(clean):
                if text is not None and _token_admissible(text, kind, extra, top):
                    row[tid] = True
        index = {mode: i for i, mode in enumerate(modes)}
        # terminal mode: whitespace continues to be admissible (handled by
        # the simulation) and EOS specials become sample-able so the model
        # can stop
        terminal = index[cls.TERMINAL]
        for eos in eos_ids or []:
            if 0 <= eos < vocab:
                mask[terminal, eos] = True
        return cls(mask=mask, mode_index=index,
                   eos_allowed_modes=[terminal])

    @classmethod
    def from_tokenizer(cls, tokenizer) -> "JsonTokenMasks":
        """Build from an HfTokenizer (llm/tokenizer.py)."""
        return build_for_tokenizer(tokenizer)[0]


def token_strings(tokenizer) -> list[str]:
    """Per-id decoded strings (the automaton's view of the vocab)."""
    return [
        tokenizer.decode([i], skip_special_tokens=False)
        for i in range(tokenizer.vocab_size)
    ]


# bump when the automaton's semantics change: stale cached tables must
# not survive an upgrade
_MASK_CACHE_VERSION = 2


def build_for_tokenizer(
    tokenizer, *, cache_dir: str | None = None
) -> tuple["JsonTokenMasks", list[str]]:
    """(masks, token_strings) for a tokenizer, with a persisted table cache.

    The table is a pure function of (vocab strings, special ids, eos ids,
    automaton version) and costs O(modes × vocab) pure-Python simulation —
    ~minutes for a 128k vocab — so it is cached on disk keyed by a content
    hash (``DYN_CACHE_DIR``, default ``~/.cache/dynamo_tpu_torch``).  Every
    worker in a fleet after the first boot loads it in milliseconds."""
    import hashlib
    import os
    from pathlib import Path

    strings = token_strings(tokenizer)
    specials = sorted(
        i for i, s in enumerate(strings) if s and not tokenizer.decode([i])
    )
    eos_ids = list(tokenizer.eos_token_ids)

    digest = hashlib.sha256()
    digest.update(str(_MASK_CACHE_VERSION).encode())
    for s in strings:
        digest.update(s.encode())
        digest.update(b"\x00")
    digest.update(repr((specials, eos_ids)).encode())
    cache_root = Path(
        cache_dir
        or knobs.get("DYN_CACHE_DIR")
        or os.path.expanduser("~/.cache/dynamo_tpu_torch")
    )
    cache_path = cache_root / f"json_masks_{digest.hexdigest()[:24]}.npz"
    if cache_path.exists():
        try:
            with np.load(cache_path) as data:
                mask = data["mask"]
            modes = _modes_universe()
            if mask.shape == (len(modes), len(strings)):
                masks = JsonTokenMasks(
                    mask=mask, mode_index={m: i for i, m in enumerate(modes)},
                )
                terminal = masks.mode_index[JsonTokenMasks.TERMINAL]
                masks.eos_allowed_modes = [terminal]
                return masks, strings
        except Exception:  # noqa: BLE001 — corrupt cache: rebuild below
            pass
    masks = JsonTokenMasks.build(
        strings, special_ids=set(specials), eos_ids=eos_ids
    )
    try:
        cache_root.mkdir(parents=True, exist_ok=True)
        # tmp name keeps the .npz suffix (np.savez appends it otherwise);
        # atomic rename so concurrent fleet boots never read a torn file
        tmp = cache_root / f".{cache_path.stem}.tmp.npz"
        np.savez_compressed(tmp, mask=masks.mask)
        os.replace(tmp, cache_path)
    except Exception:  # noqa: BLE001 — cache is an optimization only
        pass
    return masks, strings


class JsonCursor:
    """Host-side automaton state for one guided sequence."""

    def __init__(self, masks: JsonTokenMasks, token_strings: list[str],
                 eos_ids: list[int] | None = None):
        self.masks = masks
        self._strings = token_strings
        self._eos = set(eos_ids or [])
        self.kind: str = "value"
        self.extra = None
        self.stack: list[str] = []
        self.failed = False

    @property
    def complete(self) -> bool:
        return self.kind == "after" and not self.stack and not self.failed

    @property
    def mode_id(self) -> int:
        """The mask-table row for the current state (-1 once failed: the
        engine then treats the lane as unguided rather than wedging)."""
        if self.failed:
            return -1
        top = self.stack[-1] if self.stack else None
        return self.masks.mode_index[(self.kind, self.extra, top)]

    def advance(self, token_id: int) -> None:
        """Consume one sampled token (full-stack-aware transition)."""
        if self.failed:
            return
        if token_id in self._eos:
            return  # stream end; complete-ness already reflects validity
        text = self._strings[token_id] if token_id < len(self._strings) else ""
        for ch in text:
            top = self.stack[-1] if self.stack else None
            try:
                self.kind, self.extra, action = _step_char(
                    self.kind, self.extra, ch, top
                )
            except _Bad:
                # a masked-off token can only arrive here if the caller
                # bypassed the mask (unguided fallback); record and bail
                self.failed = True
                return
            if action is not None:
                if action[0] == "push":
                    self.stack.append(action[1])
                elif self.stack:
                    self.stack.pop()
                else:
                    self.failed = True
                    return
