"""GGUF model-file support (counterpart of dynamo_tpu/llm/gguf.py; reference:
lib/llm/src/gguf/* — metadata/config
parsing `ContentConfig`/`ModelConfigLike` and vocab extraction
lib/llm/src/gguf/gguf_tokenizer.rs:587).

Pure-python binary parser for GGUF v2/v3 plus:
- :func:`config_from_gguf` — llama.* metadata → :class:`LlamaConfig`;
- :func:`tokenizer_from_gguf` — ``tokenizer.ggml.*`` vocab/merges → a HF
  ``tokenizers`` BPE tokenizer (gpt2-style byte-level);
- :func:`load_gguf_weights` — F32/F16 tensors → the layer-stacked llama
  parameter tree on the device; quantized GGML types (Q4_0/Q4_1/Q5_0/
  Q5_1/Q8_0 and Q4_K/Q5_K/Q6_K) are dequantized to float in numpy on
  load, as the reference's are;
- :func:`write_gguf` — writer used by tests and for exporting small models.

GGML stores dims fastest-varying-first; numpy shapes here are the reverse.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Any, BinaryIO

import numpy as np

GGUF_MAGIC = b"GGUF"
DEFAULT_ALIGNMENT = 32

# metadata value types
T_UINT8, T_INT8, T_UINT16, T_INT16, T_UINT32, T_INT32 = range(6)
T_FLOAT32, T_BOOL, T_STRING, T_ARRAY, T_UINT64, T_INT64, T_FLOAT64 = range(6, 13)

_SCALAR_FMT = {
    T_UINT8: "<B", T_INT8: "<b", T_UINT16: "<H", T_INT16: "<h",
    T_UINT32: "<I", T_INT32: "<i", T_FLOAT32: "<f",
    T_UINT64: "<Q", T_INT64: "<q", T_FLOAT64: "<d",
}

# GGML tensor dtypes
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q4_1 = 2, 3
GGML_Q5_0, GGML_Q5_1, GGML_Q8_0 = 6, 7, 8
GGML_Q2_K, GGML_Q3_K, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K = 10, 11, 12, 13, 14
GGML_BF16 = 30
_GGML_NUMPY = {GGML_F32: np.float32, GGML_F16: np.float16}
GGML_TYPE_NAMES = {
    GGML_F32: "F32", GGML_F16: "F16", GGML_Q4_0: "Q4_0", GGML_Q4_1: "Q4_1",
    GGML_Q5_0: "Q5_0", GGML_Q5_1: "Q5_1", GGML_Q8_0: "Q8_0",
    GGML_Q2_K: "Q2_K", GGML_Q3_K: "Q3_K", GGML_Q4_K: "Q4_K",
    GGML_Q5_K: "Q5_K", GGML_Q6_K: "Q6_K", GGML_BF16: "BF16",
}

# bytes per block, weights per block (llama.cpp ggml-common.h block layouts)
GGML_BLOCK_SIZES = {
    GGML_Q4_0: (18, 32), GGML_Q4_1: (20, 32),
    GGML_Q5_0: (22, 32), GGML_Q5_1: (24, 32), GGML_Q8_0: (34, 32),
    GGML_Q4_K: (144, 256), GGML_Q5_K: (176, 256), GGML_Q6_K: (210, 256),
}


# ---------------------------------------------------------------- dequant
# Vectorized numpy dequantization of the dominant GGML quantized formats
# (reference parses the full quant range, lib/llm/src/gguf/*; llama.cpp
# dequantize_row_* are the layout ground truth).  All return float32.

def _f16(b: np.ndarray) -> np.ndarray:
    """[nb, 2] uint8 → [nb, 1] float32 (little-endian fp16 scales)."""
    return np.ascontiguousarray(b).view(np.float16).astype(np.float32)


def _dequant_q4_0(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, 0:2])
    qs = blocks[:, 2:18]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1).astype(np.float32) - 8.0
    return d * q


def _dequant_q4_1(blocks: np.ndarray) -> np.ndarray:
    d, m = _f16(blocks[:, 0:2]), _f16(blocks[:, 2:4])
    qs = blocks[:, 4:20]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1).astype(np.float32)
    return d * q + m


def _unpack_qh(qh_bytes: np.ndarray) -> np.ndarray:
    """[nb, 4] uint8 → [nb, 32] the per-weight 5th bit (0/1)."""
    qh = np.ascontiguousarray(qh_bytes).view(np.uint32)  # [nb, 1]
    shifts = np.arange(32, dtype=np.uint32)
    return ((qh >> shifts) & 1).astype(np.uint8)


def _dequant_q5_0(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, 0:2])
    hi = _unpack_qh(blocks[:, 2:6])
    qs = blocks[:, 6:22]
    lo = np.concatenate([qs & 0xF, qs >> 4], axis=1)
    q = (lo | (hi << 4)).astype(np.float32) - 16.0
    return d * q


def _dequant_q5_1(blocks: np.ndarray) -> np.ndarray:
    d, m = _f16(blocks[:, 0:2]), _f16(blocks[:, 2:4])
    hi = _unpack_qh(blocks[:, 4:8])
    qs = blocks[:, 8:24]
    lo = np.concatenate([qs & 0xF, qs >> 4], axis=1)
    q = (lo | (hi << 4)).astype(np.float32)
    return d * q + m


def _dequant_q8_0(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, 0:2])
    q = np.ascontiguousarray(blocks[:, 2:34]).view(np.int8).astype(np.float32)
    return d * q


def _k_scale_min(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Q4_K/Q5_K 6-bit packed sub-block scales/mins: [nb, 12] uint8 →
    ([nb, 8], [nb, 8]) (llama.cpp get_scale_min_k4)."""
    sc = np.empty(scales.shape[:1] + (8,), np.uint8)
    mn = np.empty_like(sc)
    for j in range(4):
        sc[:, j] = scales[:, j] & 63
        mn[:, j] = scales[:, j + 4] & 63
    for j in range(4, 8):
        sc[:, j] = (scales[:, j + 4] & 0xF) | ((scales[:, j - 4] >> 6) << 4)
        mn[:, j] = (scales[:, j + 4] >> 4) | ((scales[:, j] >> 6) << 4)
    return sc, mn


def _dequant_q4_k(blocks: np.ndarray) -> np.ndarray:
    nb = blocks.shape[0]
    d, dmin = _f16(blocks[:, 0:2]), _f16(blocks[:, 2:4])
    sc, mn = _k_scale_min(blocks[:, 4:16])
    qs = blocks[:, 16:144].reshape(nb, 4, 32)  # 4 chunks of 64 weights
    # chunk i: low nibbles → sub-block 2i, high nibbles → sub-block 2i+1
    q = np.stack([qs & 0xF, qs >> 4], axis=2).reshape(nb, 8, 32).astype(np.float32)
    w = d[:, None] * sc.astype(np.float32)[..., None] * q \
        - dmin[:, None] * mn.astype(np.float32)[..., None]
    return w.reshape(nb, 256)


def _dequant_q5_k(blocks: np.ndarray) -> np.ndarray:
    nb = blocks.shape[0]
    d, dmin = _f16(blocks[:, 0:2]), _f16(blocks[:, 2:4])
    sc, mn = _k_scale_min(blocks[:, 4:16])
    qh = blocks[:, 16:48]                      # [nb, 32]
    qs = blocks[:, 48:176].reshape(nb, 4, 32)  # 4 chunks of 64 weights
    lo = np.stack([qs & 0xF, qs >> 4], axis=2)            # [nb, 4, 2, 32]
    shifts = (2 * np.arange(4, dtype=np.uint8))[None, :, None, None] \
        + np.arange(2, dtype=np.uint8)[None, None, :, None]
    hi = (qh[:, None, None, :] >> shifts) & 1
    q = (lo + (hi << 4)).reshape(nb, 8, 32).astype(np.float32)
    w = d[:, None] * sc.astype(np.float32)[..., None] * q \
        - dmin[:, None] * mn.astype(np.float32)[..., None]
    return w.reshape(nb, 256)


def _dequant_q6_k(blocks: np.ndarray) -> np.ndarray:
    nb = blocks.shape[0]
    ql = blocks[:, 0:128].reshape(nb, 2, 64)     # two 128-weight halves
    qh = blocks[:, 128:192].reshape(nb, 2, 32)
    scales = np.ascontiguousarray(blocks[:, 192:208]).view(np.int8)  # [nb, 16]
    d = _f16(blocks[:, 208:210])
    l_lo, l_hi = ql[:, :, :32], ql[:, :, 32:]
    h = qh  # [nb, 2, 32]
    q1 = (l_lo & 0xF) | (((h >> 0) & 3) << 4)    # weights   0..31 of half
    q2 = (l_hi & 0xF) | (((h >> 2) & 3) << 4)    # weights  32..63
    q3 = (l_lo >> 4) | (((h >> 4) & 3) << 4)     # weights  64..95
    q4 = (l_hi >> 4) | (((h >> 6) & 3) << 4)     # weights  96..127
    q = np.concatenate([q1, q2, q3, q4], axis=2).astype(np.float32) - 32.0
    # scale index: within half n, weight j uses scales[8n + j//16]
    sc = scales.reshape(nb, 2, 8).astype(np.float32)
    w = d[:, None] * np.repeat(sc, 16, axis=2) * q
    return w.reshape(nb, 256)


_DEQUANT = {
    GGML_Q4_0: _dequant_q4_0, GGML_Q4_1: _dequant_q4_1,
    GGML_Q5_0: _dequant_q5_0, GGML_Q5_1: _dequant_q5_1,
    GGML_Q8_0: _dequant_q8_0,
    GGML_Q4_K: _dequant_q4_k, GGML_Q5_K: _dequant_q5_k,
    GGML_Q6_K: _dequant_q6_k,
}


def quantize_q8_0(w: np.ndarray) -> np.ndarray:
    """float weights → Q8_0 block bytes (for the writer/tests).  Rows of 32."""
    flat = np.asarray(w, np.float32).reshape(-1, 32)
    amax = np.abs(flat).max(axis=1, keepdims=True)
    d = (amax / 127.0).astype(np.float16)
    scale = np.where(d == 0, 1.0, d.astype(np.float32))
    q = np.round(flat / scale).clip(-127, 127).astype(np.int8)
    return np.concatenate([d.view(np.uint8), q.view(np.uint8)], axis=1)


def quantize_q4_0(w: np.ndarray) -> np.ndarray:
    """float weights → Q4_0 block bytes.  Rows of 32."""
    flat = np.asarray(w, np.float32).reshape(-1, 32)
    idx = np.abs(flat).argmax(axis=1)
    maxv = flat[np.arange(flat.shape[0]), idx]
    d = (maxv / -8.0).astype(np.float16)
    scale = np.where(d == 0, 1.0, d.astype(np.float32))[:, None]
    q = (np.round(flat / scale) + 8).clip(0, 15).astype(np.uint8)
    packed = q[:, :16] | (q[:, 16:] << 4)
    return np.concatenate([d[:, None].view(np.uint8), packed], axis=1)


@dataclass
class GGUFTensorInfo:
    name: str
    shape: tuple[int, ...]       # numpy order (reversed from on-disk ggml dims)
    ggml_type: int
    offset: int                  # relative to data section start

    @property
    def type_name(self) -> str:
        return GGML_TYPE_NAMES.get(self.ggml_type, f"ggml#{self.ggml_type}")


def _read_str(f: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8")


def _read_value(f: BinaryIO, vtype: int) -> Any:
    if vtype in _SCALAR_FMT:
        fmt = _SCALAR_FMT[vtype]
        return struct.unpack(fmt, f.read(struct.calcsize(fmt)))[0]
    if vtype == T_BOOL:
        return f.read(1) != b"\x00"
    if vtype == T_STRING:
        return _read_str(f)
    if vtype == T_ARRAY:
        (item_type,) = struct.unpack("<I", f.read(4))
        (count,) = struct.unpack("<Q", f.read(8))
        return [_read_value(f, item_type) for _ in range(count)]
    raise ValueError(f"unknown GGUF metadata value type {vtype}")


class GGUFFile:
    """Parsed GGUF container: ``metadata`` dict + tensor directory with lazy
    data access (memmap)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.metadata: dict[str, Any] = {}
        self.tensors: dict[str, GGUFTensorInfo] = {}
        with open(self.path, "rb") as f:
            if f.read(4) != GGUF_MAGIC:
                raise ValueError(f"{path}: not a GGUF file")
            (self.version,) = struct.unpack("<I", f.read(4))
            if self.version not in (2, 3):
                raise ValueError(f"{path}: unsupported GGUF version {self.version}")
            n_tensors, n_kv = struct.unpack("<QQ", f.read(16))
            for _ in range(n_kv):
                key = _read_str(f)
                (vtype,) = struct.unpack("<I", f.read(4))
                self.metadata[key] = _read_value(f, vtype)
            for _ in range(n_tensors):
                name = _read_str(f)
                (n_dims,) = struct.unpack("<I", f.read(4))
                dims = struct.unpack(f"<{n_dims}Q", f.read(8 * n_dims))
                ggml_type, offset = struct.unpack("<IQ", f.read(12))
                self.tensors[name] = GGUFTensorInfo(
                    name=name, shape=tuple(reversed(dims)), ggml_type=ggml_type,
                    offset=offset,
                )
            alignment = int(self.metadata.get("general.alignment", DEFAULT_ALIGNMENT))
            pos = f.tell()
            self.data_start = (pos + alignment - 1) // alignment * alignment

    def tensor_data(self, name: str) -> np.ndarray:
        """Load one tensor: F32/F16/BF16 directly; quantized GGML formats
        (Q4_0/Q4_1/Q5_0/Q5_1/Q8_0 and the Q4_K/Q5_K/Q6_K k-quants behind
        the common Q4_K_M/Q5_K_M/Q8_0 exports) dequantize to float32."""
        info = self.tensors[name]
        n = int(np.prod(info.shape))
        if info.ggml_type == GGML_BF16:
            raw = np.memmap(self.path, np.uint16, "r", self.data_start + info.offset, n)
            return (raw.astype(np.uint32) << 16).view(np.float32).reshape(info.shape)
        dtype = _GGML_NUMPY.get(info.ggml_type)
        if dtype is not None:
            return np.array(
                np.memmap(self.path, dtype, "r", self.data_start + info.offset,
                          n).reshape(info.shape)
            )
        dequant = _DEQUANT.get(info.ggml_type)
        if dequant is None:
            raise NotImplementedError(
                f"tensor {name!r} has unsupported quantized type {info.type_name}"
            )
        block_bytes, block_weights = GGML_BLOCK_SIZES[info.ggml_type]
        if n % block_weights:
            raise ValueError(
                f"tensor {name!r}: {n} weights not a multiple of the "
                f"{info.type_name} block size {block_weights}"
            )
        nbytes = n // block_weights * block_bytes
        raw = np.array(
            np.memmap(self.path, np.uint8, "r", self.data_start + info.offset, nbytes)
        ).reshape(-1, block_bytes)
        return dequant(raw).reshape(info.shape)


# ------------------------------------------------------------------ writer


def _write_str(f: BinaryIO, s: str) -> None:
    b = s.encode("utf-8")
    f.write(struct.pack("<Q", len(b)))
    f.write(b)


def _value_type(v: Any) -> int:
    if isinstance(v, bool):
        return T_BOOL
    if isinstance(v, int):
        return T_UINT32 if 0 <= v < 2**32 else T_INT64
    if isinstance(v, float):
        return T_FLOAT32
    if isinstance(v, str):
        return T_STRING
    if isinstance(v, (list, tuple)):
        return T_ARRAY
    raise TypeError(f"cannot encode {type(v)} in GGUF metadata")


def _write_value(f: BinaryIO, v: Any, vtype: int | None = None) -> None:
    vtype = _value_type(v) if vtype is None else vtype
    if vtype in _SCALAR_FMT:
        f.write(struct.pack(_SCALAR_FMT[vtype], v))
    elif vtype == T_BOOL:
        f.write(b"\x01" if v else b"\x00")
    elif vtype == T_STRING:
        _write_str(f, v)
    elif vtype == T_ARRAY:
        item_type = _value_type(v[0]) if v else T_UINT32
        f.write(struct.pack("<I", item_type))
        f.write(struct.pack("<Q", len(v)))
        for item in v:
            _write_value(f, item, item_type)


def write_gguf(
    path: str | Path, metadata: dict[str, Any], tensors: dict[str, Any]
) -> None:
    """Write a GGUF v3 file (numpy-order shapes).  Tensor values are float
    arrays (stored F32/F16) or ``(ggml_type, shape, block_bytes)`` tuples
    for pre-quantized data (e.g. from :func:`quantize_q8_0`)."""
    with open(path, "wb") as f:
        f.write(GGUF_MAGIC)
        f.write(struct.pack("<I", 3))
        f.write(struct.pack("<QQ", len(tensors), len(metadata)))
        for key, value in metadata.items():
            _write_str(f, key)
            vtype = _value_type(value)
            f.write(struct.pack("<I", vtype))
            _write_value(f, value, vtype)

        offset = 0
        arrays: list[np.ndarray] = []
        for name, arr in tensors.items():
            if isinstance(arr, tuple):
                ggml_type, shape, raw = arr
                arr = np.ascontiguousarray(raw).view(np.uint8).ravel()
                block_bytes, block_weights = GGML_BLOCK_SIZES[ggml_type]
                n = int(np.prod(shape))
                if n % block_weights or arr.nbytes != n // block_weights * block_bytes:
                    raise ValueError(
                        f"tensor {name!r}: {arr.nbytes} quantized bytes do not "
                        f"match shape {tuple(shape)} for {GGML_TYPE_NAMES[ggml_type]}"
                    )
            else:
                arr = np.ascontiguousarray(arr)
                if arr.dtype == np.float64:
                    arr = arr.astype(np.float32)
                ggml_type = {np.dtype(np.float32): GGML_F32, np.dtype(np.float16): GGML_F16}[arr.dtype]
                shape = arr.shape
            _write_str(f, name)
            f.write(struct.pack("<I", len(shape)))
            f.write(struct.pack(f"<{len(shape)}Q", *reversed(shape)))
            f.write(struct.pack("<IQ", ggml_type, offset))
            arrays.append(arr)
            size = arr.nbytes
            offset += (size + DEFAULT_ALIGNMENT - 1) // DEFAULT_ALIGNMENT * DEFAULT_ALIGNMENT

        pos = f.tell()
        f.write(b"\x00" * ((pos + DEFAULT_ALIGNMENT - 1) // DEFAULT_ALIGNMENT * DEFAULT_ALIGNMENT - pos))
        for arr in arrays:
            data = arr.tobytes()
            f.write(data)
            pad = (len(data) + DEFAULT_ALIGNMENT - 1) // DEFAULT_ALIGNMENT * DEFAULT_ALIGNMENT - len(data)
            f.write(b"\x00" * pad)


# ---------------------------------------------------------- config/tokenizer


def config_from_gguf(gguf: "GGUFFile"):
    """``llama.*`` metadata → LlamaConfig (reference: ContentConfig /
    ModelConfigLike extraction)."""
    from dynamo_tpu_torch.models.llama import LlamaConfig

    meta = gguf.metadata
    arch = meta.get("general.architecture", "llama")
    if arch not in ("llama", "qwen2"):
        raise ValueError(f"unsupported GGUF architecture {arch!r}")

    def key(suffix: str, default=None):
        return meta.get(f"{arch}.{suffix}", default)

    hidden = int(key("embedding_length"))
    heads = int(key("attention.head_count"))
    vocab = int(key("vocab_size", 0)) or len(meta.get("tokenizer.ggml.tokens", []))
    has_lm_head = "output.weight" in gguf.tensors
    return LlamaConfig(
        vocab_size=vocab,
        hidden_size=hidden,
        intermediate_size=int(key("feed_forward_length")),
        num_layers=int(key("block_count")),
        num_heads=heads,
        num_kv_heads=int(key("attention.head_count_kv", heads)),
        head_dim=int(key("attention.key_length", hidden // heads)),
        max_position_embeddings=int(key("context_length", 4096)),
        rope_theta=float(key("rope.freq_base", 10000.0)),
        rms_norm_eps=float(key("attention.layer_norm_rms_epsilon", 1e-5)),
        tie_word_embeddings=not has_lm_head,
        attention_bias=f"blk.0.attn_q.bias" in gguf.tensors,
    )


def tokenizer_from_gguf(gguf: "GGUFFile"):
    """Build a HF ``tokenizers`` tokenizer from ``tokenizer.ggml.*`` vocab.

    Supports the two GGUF tokenizer families (reference parses both,
    lib/llm/src/gguf/gguf_tokenizer.rs:587):
    - ``gpt2``: byte-level BPE from tokens + merges;
    - ``llama``: SentencePiece-style Unigram from tokens + scores, with
      Metaspace pre-tokenization and byte-fallback tokens.
    """
    from tokenizers import Tokenizer, decoders, pre_tokenizers
    from tokenizers.models import BPE, Unigram

    meta = gguf.metadata
    model_kind = meta.get("tokenizer.ggml.model", "gpt2")
    tokens: list[str] = meta["tokenizer.ggml.tokens"]
    if model_kind == "gpt2":
        merges_raw: list[str] = meta.get("tokenizer.ggml.merges", [])
        vocab = {tok: i for i, tok in enumerate(tokens)}
        merges = [tuple(m.split(" ", 1)) for m in merges_raw]
        tok = Tokenizer(BPE(vocab, merges, fuse_unk=False))
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
        tok.decoder = decoders.ByteLevel()
        return tok
    if model_kind == "llama":
        scores: list[float] = meta.get("tokenizer.ggml.scores") or [0.0] * len(tokens)
        unk_id = int(meta.get("tokenizer.ggml.unknown_token_id", 0))
        # llama-family vocabs carry <0x00>..<0xFF> byte tokens: characters
        # absent from the vocab encode through them (byte_fallback), and
        # generated byte tokens must decode as UTF-8 bytes, not literals
        tok = Tokenizer(
            Unigram(
                [(t, float(s)) for t, s in zip(tokens, scores)],
                unk_id=unk_id,
                byte_fallback=True,
            )
        )
        tok.pre_tokenizer = pre_tokenizers.Metaspace(
            replacement="▁", prepend_scheme="first"
        )
        tok.decoder = decoders.Sequence(
            [
                decoders.Replace("▁", " "),
                decoders.ByteFallback(),
                decoders.Fuse(),
                decoders.Strip(" ", 1, 0),
            ]
        )
        return tok
    raise NotImplementedError(
        f"GGUF tokenizer model {model_kind!r} not supported (gpt2 BPE / llama SPM)"
    )


def mdc_from_gguf(path: str | Path, name: str | None = None):
    """GGUF file → ModelDeploymentCard (context length, eos, chat template)."""
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    gguf = GGUFFile(path)
    meta = gguf.metadata
    arch = meta.get("general.architecture", "llama")
    eos = meta.get("tokenizer.ggml.eos_token_id")
    return ModelDeploymentCard(
        name=name or meta.get("general.name", Path(path).stem),
        path=str(path),
        context_length=int(meta.get(f"{arch}.context_length", 4096)),
        eos_token_ids=[int(eos)] if eos is not None else [],
        chat_template=meta.get("tokenizer.chat_template"),
        model_type=arch,
    ).finalize()


# ------------------------------------------------------------------ weights

# llama.cpp tensor names → our layer-stacked pytree.  GGML stores
# projections as numpy [out, in] after dim reversal → transpose like HF.
_GGUF_LAYER_MAP = {
    "attn_norm": "blk.{i}.attn_norm.weight",
    "wq": "blk.{i}.attn_q.weight",
    "wk": "blk.{i}.attn_k.weight",
    "wv": "blk.{i}.attn_v.weight",
    "wo": "blk.{i}.attn_output.weight",
    "mlp_norm": "blk.{i}.ffn_norm.weight",
    "w_gate": "blk.{i}.ffn_gate.weight",
    "w_up": "blk.{i}.ffn_up.weight",
    "w_down": "blk.{i}.ffn_down.weight",
}


def load_gguf_weights(cfg, gguf: "GGUFFile", device="cuda") -> dict:
    """GGUF tensors → the llama parameter tree on ``device`` in ``cfg.dtype``
    (the layout of ``models.llama.load_hf_weights``): each tensor read (and
    dequantized) on the host as the file stores it, copied to the device,
    and there transposed where the layout wants it and cast, a layer at a
    time into its stacked leaf."""
    import torch

    def read(name: str) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(gguf.tensor_data(name))).to(device)

    def get(name: str, transpose: bool = False) -> torch.Tensor:
        t = read(name)
        return (t.T if transpose else t).to(cfg.dtype).contiguous()

    layer_map = dict(_GGUF_LAYER_MAP)
    if cfg.attention_bias:
        layer_map.update(
            bq="blk.{i}.attn_q.bias", bk="blk.{i}.attn_k.bias", bv="blk.{i}.attn_v.bias"
        )
    layers: dict[str, torch.Tensor] = {}
    for ours, theirs in layer_map.items():
        for i in range(cfg.num_layers):
            t = read(theirs.format(i=i))
            if ours.startswith("w"):
                t = t.T
            if i == 0:
                layers[ours] = torch.empty((cfg.num_layers, *t.shape), dtype=cfg.dtype,
                                           device=device)
            layers[ours][i].copy_(t)
    params = {
        "embed": get("token_embd.weight"),
        "final_norm": get("output_norm.weight"),
        "layers": layers,
    }
    if not cfg.tie_word_embeddings and "output.weight" in gguf.tensors:
        params["lm_head"] = get("output.weight", transpose=True)
    return params
