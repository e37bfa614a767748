"""KV-block handoff frames — the wire unit of disaggregated serving
(counterpart of ``elephas_tpu/serving/handoff.py``).

A prefill-tier replica runs chunked prefill into its ``PagedKVPool``,
exports the request's filled blocks (``PagedKVPool.export_blocks``) and
parks them on the scheduler (``pop_handoff``). This module packs that
parked dict into ONE zero-copy wire frame — ``MAGIC_KV``, the fourth
packed payload kind in ``parameter.wire``, byte-identical to the JAX
package's frame — for a decode engine of either package:

    [b"EPKV"][u32 header_len][JSON header][64B-aligned raw K/V blocks]

The JSON header carries the request resume state (prompt, first token,
budget, deadline, tenant) plus per-leaf dtype/shape/offset rows; the
payload is the raw block bytes, scatter-gathered on send and viewed
in place on receive where the buffer is writable (CPU tensors; the
decode-side import uploads them to the device). ``decode_handoff`` validates every
required key BEFORE anything binds to a slot, so a corrupt frame raises
``WireFormatError`` and degrades to a local re-prefill instead of
wedging the decode replica.
"""

from __future__ import annotations

from typing import Any, Dict

from elephas_tpu_torch.parameter.wire import (
    Frames,
    WireFormatError,
    decode_kv_blocks,
    encode_kv_blocks,
)

__all__ = ["encode_handoff", "decode_handoff"]

# Resume state a decode replica cannot proceed without. ``stop_token``
# and ``deadline`` are required KEYS but may be null.
_REQUIRED = (
    "req_id",
    "prompt",
    "first",
    "max_new_tokens",
    "stop_token",
    "deadline",
    "submitted_at",
    "tenant",
    "matched",
)
_EXPORT_REQUIRED = ("block_size", "blocks", "leaves")


def encode_handoff(data: Dict[str, Any]) -> Frames:
    """Pack a scheduler-parked handoff dict into a ``MAGIC_KV`` frame.

    ``data`` is exactly what ``ContinuousBatchingScheduler.pop_handoff``
    returns; its ``export["arrays"]`` become the raw payload, everything
    else rides in the JSON header.
    """
    export = data.get("export")
    if not isinstance(export, dict) or "arrays" not in export:
        raise WireFormatError("handoff dict has no export['arrays']")
    meta = {k: v for k, v in data.items() if k != "export"}
    meta["export"] = {k: v for k, v in export.items() if k != "arrays"}
    missing = [k for k in _REQUIRED if k not in meta]
    missing += [k for k in _EXPORT_REQUIRED if k not in meta["export"]]
    if missing:
        raise WireFormatError(f"handoff dict missing keys: {missing}")
    return encode_kv_blocks(meta, export["arrays"])


def decode_handoff(buf) -> Dict[str, Any]:
    """Inverse of ``encode_handoff``: frame bytes → parked-dict shape.

    Validates the resume-state schema up front; the returned arrays are
    CPU tensors viewing ``buf`` where it is writable (valid as long as
    ``buf`` lives — ``PagedKVPool.import_blocks`` uploads them to the
    device at once).
    """
    meta, arrays = decode_kv_blocks(buf)
    missing = [k for k in _REQUIRED if k not in meta]
    export = meta.get("export")
    if not isinstance(export, dict):
        raise WireFormatError("handoff header has no export section")
    missing += [k for k in _EXPORT_REQUIRED if k not in export]
    if missing:
        raise WireFormatError(f"handoff frame missing keys: {missing}")
    if not isinstance(meta["prompt"], list) or not meta["prompt"]:
        raise WireFormatError("handoff prompt must be a non-empty list")
    if len(arrays) != len(export["leaves"]):
        raise WireFormatError(
            f"handoff carries {len(arrays)} leaves, header names "
            f"{len(export['leaves'])}"
        )
    data = dict(meta)
    data["export"] = dict(export)
    data["export"]["arrays"] = arrays
    return data
