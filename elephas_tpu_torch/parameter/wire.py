"""Packed zero-copy wire codec for parameter-server payloads (counterpart
of ``elephas_tpu/parameter/wire.py``).

Frames are byte-identical to the JAX package's for the same tree, so a
port client and a JAX server (or a JAX client and a port server) talk:

    [magic "EPK1"][u32 header_len][header JSON][pad][payload region]

- The header is small JSON metadata: a structure *skeleton* (dict keys
  in the tree's own order, list arity, leaves as indices) and per-leaf
  ``(dtype, shape, offset, nbytes, qdtype, scale)`` rows pointing into
  ONE contiguous payload region, each leaf 64-byte aligned.
- **Encode is zero-copy**: each contiguous leaf goes out as a
  ``memoryview`` of its own host buffer (``Frames.chunks``). Leaves may
  be NumPy arrays, Python scalars or CPU tensors; the caller copies
  device tensors to the host first.
- **Decode is zero-copy where the buffer is writable**: every leaf comes
  back as a CPU ``torch.Tensor`` viewing the received frame. (A
  read-only buffer costs one copy per leaf: torch cannot view it.)
- bfloat16 has no NumPy dtype without ``ml_dtypes``, which the port does
  not use: a bf16 leaf travels as its 16-bit pattern (a tensor
  ``view(torch.int16)``) under the dtype name ``"bfloat16"``, as the JAX
  package writes it.
- Optional **delta quantization** (``quantize='bf16'|'f16'``) casts
  float leaves per leaf (f16 with a per-leaf scale inside ±65504); decode
  restores the original dtype. Lossy; the unquantized path is bit-exact.
- A **not-modified** frame (``EPNM`` + u64 version) answers a pull whose
  client holds the current version; a **rejected** frame (``EPRJ`` +
  version, lag, bound) answers a push the admission policy refused.
- Frames self-describe by magic (pickle protocol ≥ 2 starts with
  ``b"\\x80"``), so every receive path also takes legacy pickle bodies.
  This module is the port's only home of ``pickle`` in ``parameter/``.

- A **KV-block handoff** frame (``EPKV``; ``encode_kv_blocks`` /
  ``decode_kv_blocks``) carries one request's filled KV blocks between a
  prefill engine and a decode engine: a free-form JSON ``meta`` dict and
  the block arrays, 64-byte aligned, byte-identical to the JAX
  package's frame for the same meta and arrays.
"""

from __future__ import annotations

import json
import pickle
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from elephas_tpu_torch.utils.functional_utils import tree_leaves_with_path
from elephas_tpu_torch.utils.sockets import (MAGIC_KV, MAGIC_NOTMOD, MAGIC_REJECT,
                                             MAGIC_TREE, RawPayload)

__all__ = [
    "DecodedTree",
    "DeltaRejected",
    "Frames",
    "NotModified",
    "WireFormatError",
    "decode",
    "decode_kv_blocks",
    "decode_payload",
    "decode_payload_traced",
    "decode_pickle",
    "decode_push",
    "encode_kv_blocks",
    "encode_not_modified",
    "encode_pickle",
    "encode_rejected",
    "encode_tree",
    "is_packed",
]

_HLEN = struct.Struct("!I")
_U64 = struct.Struct("!Q")
_ALIGN = 64  # leaf offsets are 64B-aligned so frombuffer views vectorize
_PREFIX = len(MAGIC_TREE) + _HLEN.size
_BF16 = "bfloat16"

# f16 quantization headroom: per-leaf scale maps max|x| to this, safely
# inside float16's ±65504 so the cast never overflows to inf.
_F16_HEADROOM = 6.0e4


class WireFormatError(ValueError):
    """Malformed, truncated, or structurally unsupported wire frame."""


class Frames(RawPayload):
    """An encoded frame as scatter-gather chunks (no concatenation).

    The socket layer sends the chunks directly (``utils.sockets.send``),
    the HTTP server writes them one after another; ``tobytes()`` is for
    callers that need one buffer (HTTP request bodies, tests).
    """

    __slots__ = ()

    def tobytes(self) -> bytes:
        return b"".join(bytes(c) for c in self.chunks)


class NotModified:
    """Decoded ``EPNM`` frame: the server's tree is unchanged at ``version``."""

    __slots__ = ("version",)

    def __init__(self, version: int):
        self.version = version

    def __repr__(self):
        return f"NotModified(version={self.version})"


class DeltaRejected:
    """Decoded ``EPRJ`` frame: the server refused a pushed delta, staler
    than its admission bound. ``version`` is the server's live version
    (the re-pull target), ``lag`` the measured staleness and
    ``max_staleness`` the bound it crossed."""

    __slots__ = ("version", "lag", "max_staleness")

    def __init__(self, version: int, lag: int, max_staleness: int):
        self.version = version
        self.lag = lag
        self.max_staleness = max_staleness

    def __repr__(self):
        return (f"DeltaRejected(version={self.version}, lag={self.lag}, "
                f"max_staleness={self.max_staleness})")


class DecodedTree:
    """Decoded ``EPK1`` frame: ``tree`` (zero-copy tensor leaves) and the
    optional header stamps — ``version``, the serving server's ``boot``
    id, the sender's ``trace`` pair, and on a push the ``seen_version``
    it trained against, its ``worker`` id and its ``sync_interval``."""

    __slots__ = ("tree", "version", "boot", "trace", "seen_version",
                 "worker", "sync_interval")

    def __init__(self, tree, version: Optional[int], boot: Optional[str] = None,
                 trace: Optional[Tuple[str, str]] = None,
                 seen_version: Optional[int] = None,
                 worker: Optional[str] = None,
                 sync_interval: Optional[float] = None):
        self.tree = tree
        self.version = version
        self.boot = boot
        self.trace = trace
        self.seen_version = seen_version
        self.worker = worker
        self.sync_interval = sync_interval


def is_packed(buf) -> bool:
    """True iff ``buf`` starts with a packed-codec magic."""
    head = bytes(memoryview(buf)[:4])
    return (head == MAGIC_TREE or head == MAGIC_NOTMOD
            or head == MAGIC_REJECT or head == MAGIC_KV)


# -- structure skeleton -------------------------------------------------------
#
# ["d", [[key, sub], ...]] for dicts (in the dict's own order), ["l"/"t",
# [sub, ...]] for lists/tuples, ["z"] for None, ["f", i] for leaf i.


def _build_skeleton(obj, leaves: List[Any]):
    if obj is None:
        return ["z"]
    if isinstance(obj, dict):
        items = []
        for key, val in obj.items():
            if not isinstance(key, (str, int, float, bool)):
                raise WireFormatError(
                    f"packed codec needs JSON-able dict keys, got {type(key)}"
                )
            items.append([key, _build_skeleton(val, leaves)])
        return ["d", items]
    if isinstance(obj, (list, tuple)):
        tag = "l" if isinstance(obj, list) else "t"
        return [tag, [_build_skeleton(v, leaves) for v in obj]]
    idx = len(leaves)
    leaves.append(obj)
    return ["f", idx]


def _restore_skeleton(skel, leaves: List[Any]):
    tag = skel[0]
    if tag == "z":
        return None
    if tag == "f":
        return leaves[skel[1]]
    if tag == "d":
        return {key: _restore_skeleton(sub, leaves) for key, sub in skel[1]}
    if tag == "l":
        return [_restore_skeleton(sub, leaves) for sub in skel[1]]
    if tag == "t":
        return tuple(_restore_skeleton(sub, leaves) for sub in skel[1])
    raise WireFormatError(f"unknown skeleton tag {tag!r}")


# -- dtypes -------------------------------------------------------------------


def _dtype_name(leaf) -> str:
    """The JAX package's dtype name of a leaf (NumPy's names; ``bfloat16``
    as ml_dtypes names it)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).rpartition(".")[2]
    return np.asarray(leaf).dtype.name


def _host_array(leaf) -> np.ndarray:
    """A contiguous host array of the leaf's bytes: bf16 tensors as their
    16-bit patterns (int16), everything else in its own dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    arr = np.ascontiguousarray(leaf)
    if arr.dtype == object:
        raise WireFormatError("object-dtype leaf has no wire layout")
    return arr


def _np_dtype(name: str) -> np.dtype:
    """The NumPy dtype of a wire name (bf16 travels as int16 patterns)."""
    if name == _BF16:
        return np.dtype(np.int16)
    try:
        return np.dtype(name)
    except TypeError:
        raise WireFormatError(f"unknown wire dtype {name!r}") from None


def _quantize_leaf(arr: np.ndarray, quantize: str) -> Tuple[np.ndarray, str, float]:
    """(quantized array, qdtype name, scale). Raises on unknown mode."""
    if quantize == "bf16":
        # Round to nearest even, as ml_dtypes' astype does.
        bf16 = torch.from_numpy(np.ascontiguousarray(arr)).to(torch.bfloat16)
        return bf16.view(torch.int16).numpy(), _BF16, 1.0
    if quantize == "f16":
        amax = float(np.max(np.abs(arr))) if arr.size else 0.0
        if not np.isfinite(amax) or amax == 0.0:
            scale = 1.0
        else:
            scale = amax / _F16_HEADROOM
        return (arr / scale).astype(np.float16), "float16", scale
    raise WireFormatError(f"quantize must be 'bf16'|'f16', got {quantize!r}")


def _leaf_chunk(arr: np.ndarray):
    """A zero-copy byte view of a contiguous array (a copy only where the
    buffer protocol refuses the dtype)."""
    try:
        return memoryview(arr).cast("B")
    except (TypeError, ValueError, BufferError):
        return arr.tobytes()


# -- encode -------------------------------------------------------------------


def encode_tree(tree, version: Optional[int] = None,
                quantize: Optional[str] = None,
                boot: Optional[str] = None,
                trace: Optional[Tuple[str, str]] = None,
                seen_version: Optional[int] = None,
                worker: Optional[str] = None,
                sync_interval: Optional[float] = None) -> Frames:
    """Encode a tree of arrays, tensors and scalars into a packed frame.

    The optional stamps land in the header only when given (``boot`` as
    ``"boot"``, ``trace`` as ``"tc"``, ``seen_version``/``worker``/
    ``sync_interval`` as ``"sv"``/``"wk"``/``"si"``), so unstamped frames
    stay byte-identical with older peers. Raises ``WireFormatError`` for
    structures the skeleton cannot carry — callers fall back to
    ``encode_pickle``.
    """
    leaves: List[Any] = []
    skeleton = _build_skeleton(tree, leaves)

    rows = []          # (dtype, shape, offset, nbytes, qdtype, scale)
    payload_chunks = []  # alternating pads + leaf views
    offset = 0
    for leaf in leaves:
        name = _dtype_name(leaf)
        arr = _host_array(leaf)
        qdtype, scale = None, None
        if quantize is not None and name != _BF16 and arr.dtype.kind == "f" \
                and arr.dtype.itemsize > 2:
            arr, qdtype, scale = _quantize_leaf(arr, quantize)
        pad = (-offset) % _ALIGN
        if pad:
            payload_chunks.append(b"\x00" * pad)
            offset += pad
        shape = leaf.shape if isinstance(leaf, torch.Tensor) else np.shape(leaf)
        rows.append([name, list(shape), offset, arr.nbytes, qdtype, scale])
        payload_chunks.append(_leaf_chunk(arr))
        offset += arr.nbytes

    meta: Dict[str, Any] = {"v": 1, "ver": version, "skel": skeleton,
                            "leaves": rows}
    if boot is not None:
        meta["boot"] = str(boot)
    if trace is not None:
        meta["tc"] = [str(trace[0]), str(trace[1])]
    if seen_version is not None:
        meta["sv"] = int(seen_version)
    if worker is not None:
        meta["wk"] = str(worker)
    if sync_interval is not None:
        meta["si"] = float(sync_interval)
    header = json.dumps(meta, separators=(",", ":")).encode()
    # Pad the header with spaces (JSON-transparent) so the payload
    # region starts 64B-aligned relative to the frame start.
    header += b" " * ((-(_PREFIX + len(header))) % _ALIGN)
    head = MAGIC_TREE + _HLEN.pack(len(header)) + header
    return Frames([head, *payload_chunks])


def encode_not_modified(version: int) -> Frames:
    """The 12-byte "your snapshot is current" reply frame."""
    return Frames([MAGIC_NOTMOD + _U64.pack(int(version))])


def encode_rejected(version: int, lag: int, max_staleness: int) -> Frames:
    """The 28-byte "delta too stale, re-pull" push reply frame (sent only
    to peers that stamped their push with the version they trained on)."""
    return Frames([MAGIC_REJECT + _U64.pack(int(version))
                   + _U64.pack(int(lag)) + _U64.pack(int(max_staleness))])


def encode_pickle(obj) -> bytes:
    """Legacy pickle codec — the port's only sanctioned ``pickle.dumps``
    in ``parameter/``."""
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def decode_pickle(buf):
    """Legacy pickle codec. Callers MUST have authenticated ``buf`` first
    when a wire auth key is configured (``utils.sockets`` verifies the
    HMAC before any payload reaches this)."""
    return pickle.loads(bytes(buf) if isinstance(buf, memoryview) else buf)


# -- decode -------------------------------------------------------------------


def _leaf_tensor(payload: memoryview, dtype_name: str, shape, offset: int,
                 nbytes: int, qdtype: Optional[str], scale) -> torch.Tensor:
    wire_name = qdtype or dtype_name
    wire_dtype = _np_dtype(wire_name)
    arr = np.frombuffer(payload, dtype=wire_dtype, count=nbytes // wire_dtype.itemsize,
                        offset=offset).reshape(shape)
    if not arr.flags.writeable:
        arr = arr.copy()
    tensor = torch.from_numpy(arr)
    if wire_name == _BF16:
        tensor = tensor.view(torch.bfloat16)
    if qdtype is None:
        return tensor
    if qdtype == _BF16:  # bf16 → the original float dtype, exactly
        return tensor.to(getattr(torch, dtype_name))
    out = arr.astype(np.dtype(dtype_name))
    if scale != 1.0:
        out = np.asarray(out * out.dtype.type(scale))
    return torch.from_numpy(out)


def _structure(tree):
    return [path for path, _ in tree_leaves_with_path(tree)]


def decode(buf, expect=None):
    """Decode one packed frame → ``DecodedTree`` | ``NotModified`` |
    ``DeltaRejected``.

    Leaves are CPU tensors viewing ``buf`` (keep it alive as long as the
    tree). ``expect`` (a tree of the expected structure, leaves
    ignored) turns a structure mismatch into a ``WireFormatError``
    instead of a downstream apply error.
    """
    mv = memoryview(buf)
    if mv.ndim != 1 or mv.format != "B":
        mv = mv.cast("B")
    head = bytes(mv[:4])
    if head == MAGIC_NOTMOD:
        if len(mv) < 4 + _U64.size:
            raise WireFormatError("truncated not-modified frame")
        return NotModified(_U64.unpack_from(mv, 4)[0])
    if head == MAGIC_REJECT:
        if len(mv) < 4 + 3 * _U64.size:
            raise WireFormatError("truncated delta-rejected frame")
        return DeltaRejected(_U64.unpack_from(mv, 4)[0],
                             _U64.unpack_from(mv, 4 + _U64.size)[0],
                             _U64.unpack_from(mv, 4 + 2 * _U64.size)[0])
    if head != MAGIC_TREE:
        raise WireFormatError(
            f"not a packed frame (magic {head!r}; legacy pickle bodies "
            "go through decode_payload/decode_pickle)"
        )
    if len(mv) < _PREFIX:
        raise WireFormatError("truncated packed frame header")
    (hlen,) = _HLEN.unpack_from(mv, 4)
    if _PREFIX + hlen > len(mv):
        raise WireFormatError("packed frame shorter than its header length")
    try:
        header = json.loads(bytes(mv[_PREFIX:_PREFIX + hlen]))
    except ValueError as exc:
        raise WireFormatError(f"corrupt packed frame header: {exc}") from exc
    if header.get("v") != 1:
        raise WireFormatError(f"unsupported packed frame version {header.get('v')!r}")

    payload = mv[_PREFIX + hlen:]
    leaves = []
    for dtype_name, shape, offset, nbytes, qdtype, scale in header["leaves"]:
        if offset + nbytes > len(payload):
            raise WireFormatError(
                f"leaf at offset {offset} (+{nbytes}B) overruns the "
                f"{len(payload)}B payload region (truncated frame?)"
            )
        leaves.append(_leaf_tensor(payload, dtype_name, shape, offset, nbytes,
                                   qdtype, scale))
    tree = _restore_skeleton(header["skel"], leaves)
    if expect is not None and _structure(tree) != _structure(expect):
        raise WireFormatError(
            f"packed frame structure mismatch: got {_structure(tree)}, expected "
            f"{_structure(expect)}"
        )
    tc = header.get("tc")
    return DecodedTree(tree, header.get("ver"), header.get("boot"),
                       tuple(tc) if tc else None,
                       header.get("sv"), header.get("wk"),
                       header.get("si"))


def _decode_tree_frame(buf, expect):
    out = decode(buf, expect=expect)
    if isinstance(out, (NotModified, DeltaRejected)):
        raise WireFormatError(f"status frame {out!r} where a tree was expected")
    return out


def decode_payload(buf, expect=None):
    """Decode a request/response body of EITHER codec into a tree (packed
    frames self-describe by magic; anything else is legacy pickle)."""
    if is_packed(buf):
        return _decode_tree_frame(buf, expect).tree
    return decode_pickle(buf)


def decode_payload_traced(buf, expect=None):
    """``decode_payload`` that also surfaces the sender's trace context:
    ``(tree, (trace_id, span_id) | None)``."""
    if is_packed(buf):
        out = _decode_tree_frame(buf, expect)
        return out.tree, out.trace
    return decode_pickle(buf), None


# -- KV-block handoff frames --------------------------------------------------
#
# The disaggregated-serving payload kind: a prefill engine ships one
# request's filled KV blocks as
#
#     [magic "EPKV"][u32 header_len][header JSON][pad][payload region]
#
# — the layout discipline of EPK1 frames (64B-aligned leaf offsets,
# zero-copy encode through memoryview chunks), with a free-form JSON
# ``meta`` dict in place of a tree skeleton: the serving layer owns the
# metadata schema (``serving.handoff``), the codec only the bytes.


def encode_kv_blocks(meta: Dict[str, Any], arrays) -> Frames:
    """Encode a KV handoff: JSON-able ``meta`` and a list of block arrays
    (NumPy arrays or CPU tensors; bf16 tensors travel as their 16-bit
    patterns under the name ``"bfloat16"``).

    Each array lands contiguously at a 64B-aligned offset in one payload
    region; the header carries ``(dtype, shape, offset, nbytes)`` rows in
    list order. Raises ``WireFormatError`` for meta that is not JSON-able
    or an object-dtype array."""
    rows = []
    payload_chunks: List[Any] = []
    offset = 0
    for leaf in arrays:
        arr = _host_array(leaf)
        pad = (-offset) % _ALIGN
        if pad:
            payload_chunks.append(b"\x00" * pad)
            offset += pad
        rows.append([_dtype_name(leaf), list(arr.shape), offset, arr.nbytes])
        payload_chunks.append(_leaf_chunk(arr))
        offset += arr.nbytes
    try:
        header = json.dumps({"v": 1, "meta": meta, "leaves": rows},
                            separators=(",", ":")).encode()
    except (TypeError, ValueError) as exc:
        raise WireFormatError(f"KV handoff meta is not JSON-able: {exc}") from exc
    header += b" " * ((-(_PREFIX + len(header))) % _ALIGN)
    return Frames([MAGIC_KV + _HLEN.pack(len(header)) + header, *payload_chunks])


def decode_kv_blocks(buf) -> Tuple[Dict[str, Any], List[torch.Tensor]]:
    """Decode one ``EPKV`` frame to ``(meta, arrays)``.

    The arrays are CPU tensors (bf16 as ``torch.bfloat16``) viewing
    ``buf`` where it is writable (one copy each where it is not). Every
    structural defect — wrong magic, truncation, corrupt JSON, a leaf
    overrunning the payload — raises ``WireFormatError``."""
    mv = memoryview(buf)
    if mv.ndim != 1 or mv.format != "B":
        mv = mv.cast("B")
    if bytes(mv[:4]) != MAGIC_KV:
        raise WireFormatError(f"not a KV handoff frame (magic {bytes(mv[:4])!r})")
    if len(mv) < _PREFIX:
        raise WireFormatError("truncated KV handoff frame header")
    (hlen,) = _HLEN.unpack_from(mv, 4)
    if _PREFIX + hlen > len(mv):
        raise WireFormatError("KV handoff frame shorter than its header length")
    try:
        header = json.loads(bytes(mv[_PREFIX:_PREFIX + hlen]))
    except ValueError as exc:
        raise WireFormatError(f"corrupt KV handoff header: {exc}") from exc
    if header.get("v") != 1 or not isinstance(header.get("leaves"), list):
        raise WireFormatError(f"unsupported KV handoff frame version {header.get('v')!r}")
    payload = mv[_PREFIX + hlen:]
    arrays = []
    for row in header["leaves"]:
        try:
            dtype_name, shape, offset, nbytes = row
        except (TypeError, ValueError) as exc:
            raise WireFormatError(f"malformed KV leaf row {row!r}") from exc
        if offset + nbytes > len(payload):
            raise WireFormatError(
                f"KV leaf at offset {offset} (+{nbytes}B) overruns the "
                f"{len(payload)}B payload region (truncated frame?)"
            )
        try:
            arrays.append(_leaf_tensor(payload, dtype_name, shape, offset, nbytes,
                                       None, 1.0))
        except (TypeError, ValueError) as exc:
            raise WireFormatError(f"KV leaf {row!r} does not reshape: {exc}") from exc
    meta = header.get("meta")
    if not isinstance(meta, dict):
        raise WireFormatError("KV handoff frame carries no meta dict")
    return meta, arrays


def decode_push(buf, expect=None):
    """``decode_payload`` for the PS push handlers: ``(tree, trace,
    seen_version, worker, sync_interval)``; legacy pickle bodies decode
    with every stamp ``None``."""
    if is_packed(buf):
        out = _decode_tree_frame(buf, expect)
        return (out.tree, out.trace, out.seen_version, out.worker,
                out.sync_interval)
    return decode_pickle(buf), None, None, None, None
