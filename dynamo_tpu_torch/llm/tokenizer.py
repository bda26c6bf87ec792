"""Tokenizer wrapper + incremental detokenization.

Wraps HF ``tokenizers`` (reference: lib/llm/src/tokenizers.rs) and provides a
``DecodeStream`` for per-token incremental detokenization that is correct for
multi-byte/multi-token unicode: text is only released once the decoder
produces output that no longer ends in a replacement character, using the
prefix-window re-decode technique.
"""

from __future__ import annotations

import json
from pathlib import Path

from tokenizers import Tokenizer

REPLACEMENT_CHAR = "�"


def spm_conversion_available() -> bool:
    """Whether a SentencePiece tokenizer.model can be converted to a fast
    tokenizer (the conversion runs through transformers' converter, which
    needs the sentencepiece package)."""
    import importlib.util

    return (
        importlib.util.find_spec("sentencepiece") is not None
        and importlib.util.find_spec("transformers") is not None
    )


class HfTokenizer:
    def __init__(self, tokenizer: Tokenizer, *, eos_token_ids: list[int] | None = None):
        self._tk = tokenizer
        self.eos_token_ids = eos_token_ids or []

    @classmethod
    def from_file(cls, path: str | Path) -> "HfTokenizer":
        path = Path(path)
        tk = Tokenizer.from_file(str(path))
        eos_ids: list[int] = []
        config_path = path.parent / "tokenizer_config.json"
        if config_path.exists():
            config = json.loads(config_path.read_text())
            eos_token = config.get("eos_token")
            if isinstance(eos_token, dict):
                eos_token = eos_token.get("content")
            if eos_token is not None:
                eos_id = tk.token_to_id(eos_token)
                if eos_id is not None:
                    eos_ids.append(eos_id)
        return cls(tk, eos_token_ids=eos_ids)

    @classmethod
    def from_model_dir(cls, model_dir: str | Path) -> "HfTokenizer":
        """Load from a model directory: the fast ``tokenizer.json`` when
        present, else convert a SentencePiece ``tokenizer.model`` through
        transformers (needs the ``sentencepiece`` package)."""
        model_dir = Path(model_dir)
        if (model_dir / "tokenizer.json").exists():
            return cls.from_file(model_dir / "tokenizer.json")
        if (model_dir / "tokenizer.model").exists():
            if not spm_conversion_available():
                raise FileNotFoundError(
                    f"{model_dir} ships only a SentencePiece tokenizer.model "
                    "and the 'sentencepiece' package is not installed; "
                    "provide tokenizer.json or install sentencepiece"
                )
            from transformers import AutoTokenizer

            fast = AutoTokenizer.from_pretrained(str(model_dir), use_fast=True)
            eos_ids = [fast.eos_token_id] if fast.eos_token_id is not None else []
            return cls(fast.backend_tokenizer, eos_token_ids=eos_ids)
        raise FileNotFoundError(f"no tokenizer.json/tokenizer.model in {model_dir}")

    def encode(self, text: str, *, add_special_tokens: bool = False) -> list[int]:
        return self._tk.encode(text, add_special_tokens=add_special_tokens).ids

    def decode(self, ids: list[int], *, skip_special_tokens: bool = True) -> str:
        return self._tk.decode(ids, skip_special_tokens=skip_special_tokens)

    def token_to_id(self, token: str) -> int | None:
        return self._tk.token_to_id(token)

    @property
    def vocab_size(self) -> int:
        return self._tk.get_vocab_size()

    def decode_stream(self, *, skip_special_tokens: bool = True) -> "DecodeStream":
        return DecodeStream(self, skip_special_tokens=skip_special_tokens)


class DecodeStream:
    """Incremental detokenizer (reference: tokenizers DecodeStream used in
    lib/llm/src/backend.rs:70-76).

    ``step(token_id) -> str | None``: the new text produced by this token, or
    None if it is held (incomplete unicode sequence / special token).
    """

    def __init__(self, tokenizer: HfTokenizer, *, skip_special_tokens: bool = True):
        self._tk = tokenizer
        self._skip_special = skip_special_tokens
        self._ids: list[int] = []
        self._prefix_offset = 0  # window start for context-sensitive decoding
        self._read_offset = 0    # everything before this is already emitted

    def step(self, token_id: int) -> str | None:
        self._ids.append(token_id)
        prefix_text = self._tk.decode(
            self._ids[self._prefix_offset : self._read_offset],
            skip_special_tokens=self._skip_special,
        )
        new_text = self._tk.decode(
            self._ids[self._prefix_offset :], skip_special_tokens=self._skip_special
        )
        if new_text.endswith(REPLACEMENT_CHAR):
            # mid-codepoint: hold until the sequence completes
            return None
        delta = new_text[len(prefix_text):]
        self._prefix_offset = self._read_offset
        self._read_offset = len(self._ids)
        return delta if delta else None
