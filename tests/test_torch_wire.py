"""The port's wire codec and socket framing (``elephas_tpu_torch/parameter/
wire.py``, ``utils/sockets.py``) against the JAX package's.

Frames must be byte-identical for the same tree (NumPy leaves, or the
port's tensors beside the same values as NumPy), each package must decode
the other's frames to the same values, and a client of either package
must push to and pull from a server of the other with HMAC on. Every
comparison here is exact: the codec moves bytes, it computes nothing but
the quantized casts, which both packages round to nearest even.
"""

import os
import socket
import struct
import warnings

import ml_dtypes
import numpy as np
import pytest
import torch

from elephas_tpu.parameter import wire as jwire
from elephas_tpu.parameter.client import make_client as jax_client
from elephas_tpu.parameter.server import make_server as jax_server
from elephas_tpu.utils import sockets as jsockets
from elephas_tpu_torch.parameter import wire
from elephas_tpu_torch.parameter.client import make_client as port_client
from elephas_tpu_torch.parameter.server import make_server as port_server
from elephas_tpu_torch.utils import sockets


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"dense": {"kernel": rng.normal(size=(17, 5)).astype(np.float32),
                             "bias": rng.normal(size=(5,)).astype(np.float32)},
                   "conv": rng.normal(size=(3, 3, 2, 4)).astype(np.float64)},
        "batch_stats": {},
        "step": np.int64(7),
        "ids": np.arange(6, dtype=np.int32),
        "mask": np.array([True, False, True]),
        "bytes": np.arange(4, dtype=np.uint8),
        "half": rng.normal(size=(4,)).astype(np.float16),
        "stack": [rng.normal(size=(2, 3)).astype(np.float32), None],
        "pair": (np.float32(0.5), np.zeros((0, 3), np.float32)),
    }


def _as_torch(tree):
    """The same tree with every array leaf a tensor (scalars kept)."""
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_as_torch(v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


ENCODINGS = [
    {},
    {"version": 41, "boot": "a1b2c3d4e5f6"},
    {"quantize": "bf16"},
    {"quantize": "f16"},
    {"trace": ("0123456789abcdef", "fedcba98"), "seen_version": 3, "worker": "w2",
     "sync_interval": 2.5},
]


@pytest.mark.parametrize("kw", ENCODINGS, ids=lambda kw: ",".join(kw) or "plain")
def test_frames_byte_identical_to_jax(kw):
    tree = _tree()
    want = jwire.encode_tree(tree, **kw).tobytes()
    assert wire.encode_tree(tree, **kw).tobytes() == want
    assert wire.encode_tree(_as_torch(tree), **kw).tobytes() == want


def test_bf16_leaves_travel_as_their_bit_patterns():
    values = np.linspace(-3, 3, 24, dtype=np.float32).reshape(4, 6)
    want = jwire.encode_tree({"w": values.astype(ml_dtypes.bfloat16)}).tobytes()
    got = wire.encode_tree({"w": torch.from_numpy(values).to(torch.bfloat16)}).tobytes()
    assert got == want
    port = wire.decode(bytearray(want)).tree["w"]
    assert port.dtype == torch.bfloat16
    assert torch.equal(port.float(), torch.from_numpy(values).to(torch.bfloat16).float())
    jax = jwire.decode(got).tree["w"]
    assert jax.dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(np.asarray(jax, np.float32), port.float().numpy())


def test_status_frames_byte_identical():
    assert wire.encode_not_modified(12345).tobytes() == jwire.encode_not_modified(12345).tobytes()
    assert (wire.encode_rejected(9, 5, 2).tobytes()
            == jwire.encode_rejected(9, 5, 2).tobytes())
    nm = wire.decode(jwire.encode_not_modified(7).tobytes())
    assert isinstance(nm, wire.NotModified) and nm.version == 7
    rj = wire.decode(jwire.encode_rejected(9, 5, 2).tobytes())
    assert isinstance(rj, wire.DeltaRejected) and (rj.version, rj.lag, rj.max_staleness) == (9, 5, 2)
    out = jwire.decode(wire.encode_rejected(9, 5, 2).tobytes())
    assert (out.version, out.lag, out.max_staleness) == (9, 5, 2)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    elif tree is not None:
        yield prefix, tree


@pytest.mark.parametrize("kw", ENCODINGS, ids=lambda kw: ",".join(kw) or "plain")
def test_port_decodes_jax_frames(kw):
    frame = jwire.encode_tree(_tree(), **kw).tobytes()
    want, got = jwire.decode(frame), wire.decode(bytearray(frame))
    assert (got.version, got.boot, got.trace, got.seen_version, got.worker,
            got.sync_interval) == (want.version, want.boot, want.trace, want.seen_version,
                                   want.worker, want.sync_interval)
    jl, pl = dict(_leaves(want.tree)), dict(_leaves(got.tree))
    assert jl.keys() == pl.keys()
    for path, ref in jl.items():
        leaf = pl[path]
        assert isinstance(leaf, torch.Tensor), path
        assert leaf.numpy().dtype == np.asarray(ref).dtype, path
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref), err_msg=path)
    assert got.tree["batch_stats"] == {} and got.tree["stack"][1] is None
    assert isinstance(got.tree["pair"], tuple)


@pytest.mark.parametrize("kw", ENCODINGS, ids=lambda kw: ",".join(kw) or "plain")
def test_jax_decodes_port_frames(kw):
    tree = _as_torch(_tree())
    want = wire.decode(bytearray(wire.encode_tree(tree, **kw).tobytes()))
    got = jwire.decode(wire.encode_tree(tree, **kw).tobytes())
    for (path, ref), (gpath, leaf) in zip(_leaves(want.tree), _leaves(got.tree)):
        assert path == gpath
        np.testing.assert_array_equal(np.asarray(leaf), ref.numpy(), err_msg=path)


def test_decode_views_a_writable_frame_and_copies_a_read_only_one():
    tree = {"w": np.arange(1000, dtype=np.float32)}
    frame = bytearray(wire.encode_tree(tree).tobytes())
    leaf = wire.decode(frame).tree["w"]
    base = np.frombuffer(frame, np.uint8).ctypes.data
    assert base <= leaf.data_ptr() < base + len(frame)  # zero-copy view
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no "not writable" warning from torch
        copied = wire.decode(bytes(frame)).tree["w"]
    assert torch.equal(copied, leaf)


def test_malformed_frames_raise():
    frame = wire.encode_tree({"w": np.ones(64, np.float32)}).tobytes()
    with pytest.raises(wire.WireFormatError, match="overruns"):
        wire.decode(bytearray(frame[:-16]))
    with pytest.raises(wire.WireFormatError, match="not a packed frame"):
        wire.decode(b"XXXX" + frame[4:])
    bad = bytearray(frame)
    bad[8:12] = b"\xff\xff\xff\xff"
    with pytest.raises(wire.WireFormatError, match="corrupt"):
        wire.decode(bad)
    with pytest.raises(wire.WireFormatError, match="shorter than its header"):
        wire.decode(frame[:4] + struct.pack("!I", 10**6) + frame[8:])
    with pytest.raises(wire.WireFormatError, match="status frame"):
        wire.decode_payload(wire.encode_not_modified(3).tobytes())
    with pytest.raises(wire.WireFormatError, match="structure mismatch"):
        wire.decode(bytearray(frame), expect={"v": 0})
    with pytest.raises(wire.WireFormatError, match="JSON-able"):
        wire.encode_tree({(1, 2): np.ones(2)})
    with pytest.raises(wire.WireFormatError, match="quantize"):
        wire.encode_tree({"w": np.ones(2, np.float32)}, quantize="int8")


def test_pickle_bodies_and_traced_and_push_decoders():
    body = wire.encode_pickle({"a": 1})
    assert wire.decode_payload(body) == {"a": 1}
    assert wire.decode_payload_traced(body) == ({"a": 1}, None)
    frame = wire.encode_tree({"w": np.ones(2, np.float32)}, trace=("t", "s"),
                             seen_version=4, worker="w1", sync_interval=1.5).tobytes()
    tree, tc, seen, worker, si = wire.decode_push(bytearray(frame))
    assert (tc, seen, worker, si) == (("t", "s"), 4, "w1", 1.5)
    assert torch.equal(tree["w"], torch.ones(2))
    assert wire.is_packed(frame) and not wire.is_packed(body)


@pytest.mark.parametrize("key", [None, os.urandom(32)], ids=["keyless", "hmac"])
@pytest.mark.parametrize("sender", ["port", "jax"])
def test_socket_framing_interoperates(key, sender):
    send = (sockets if sender == "port" else jsockets).send
    receive = (jsockets if sender == "port" else sockets).receive
    codec = wire if sender == "port" else jwire
    frames = codec.encode_tree({"w": np.arange(8, dtype=np.float32)})
    a, b = socket.socketpair()
    try:
        send(a, ("G", ("boot", 3)), key=key)
        send(a, frames, key=key)
        assert receive(b, key=key) == ("G", ("boot", 3))
        raw = receive(b, key=key)
        assert bytes(raw) == frames.tobytes()
    finally:
        a.close()
        b.close()


def test_tampered_and_replayed_frames_are_refused():
    key = os.urandom(32)
    a, b = socket.socketpair()
    try:
        jsockets.send(a, ("u", 1), key=key)
        data = b.recv(1 << 16)
        tampered = bytearray(data)
        tampered[-1] ^= 1
        c, d = socket.socketpair()
        c.sendall(bytes(tampered))
        with pytest.raises(ConnectionError, match="authentication"):
            sockets.receive(d, key=key)
        guard = sockets.ReplayGuard()
        c.sendall(data)
        c.sendall(data)
        assert sockets.receive(d, key=key, replay_guard=guard) == ("u", 1)
        with pytest.raises(ConnectionError, match="replayed"):
            sockets.receive(d, key=key, replay_guard=guard)
        c.close()
        d.close()
    finally:
        a.close()
        b.close()


TREE = {"params": {"w": np.arange(12, dtype=np.float32).reshape(4, 3) / 7,
                   "b": np.linspace(-1, 1, 3).astype(np.float32)},
        "batch_stats": {"mean": np.full(3, 0.25, np.float32)}}
DELTA = {"params": {"w": np.full((4, 3), 0.125, np.float32),
                    "b": np.array([0.5, -0.25, 1.0], np.float32)},
         "batch_stats": {"mean": np.full(3, -0.5, np.float32)}}


def _flat(tree):
    return {p: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for p, v in _leaves(tree)}


@pytest.mark.parametrize("mode", ["socket", "http"])
def test_port_client_against_jax_server(mode):
    """With HMAC on: a pull, a push, then a pull whose bytes are the
    server's own snapshot's, exactly ``TREE - DELTA``; the second pull of
    an unchanged server is answered not-modified."""
    key = os.urandom(32)
    server = jax_server(mode, TREE, port=0, auth_key=key)
    server.start()
    try:
        client = port_client(mode, f"127.0.0.1:{server.port}", auth_key=key)
        first = client.get_parameters()
        assert _flat(first).keys() == _flat(TREE).keys()
        client.update_parameters(_as_torch(DELTA))
        pulled = client.get_parameters()
        again = client.get_parameters()
        assert again is pulled  # answered not-modified: the cached tree
        want = {p: v - _flat(DELTA)[p] for p, v in _flat(TREE).items()}
        got = _flat(pulled)
        for p, v in want.items():
            assert got[p].tobytes() == v.tobytes(), p
        assert server.buffer.version == 1
        if hasattr(client, "close"):
            client.close()
    finally:
        server.stop()


@pytest.mark.parametrize("mode", ["socket", "http"])
def test_jax_client_against_port_server(mode):
    key = os.urandom(32)
    server = port_server(mode, TREE, port=0, auth_key=key, device="cpu")
    server.start()
    try:
        client = jax_client(mode, f"127.0.0.1:{server.port}", auth_key=key)
        client.get_parameters()
        client.update_parameters(DELTA)
        pulled = client.get_parameters()
        again = client.get_parameters()
        assert again is pulled  # the port server answered not-modified
        want = {p: v - _flat(DELTA)[p] for p, v in _flat(TREE).items()}
        got = _flat(pulled)
        for p, v in want.items():
            assert np.asarray(got[p]).tobytes() == v.tobytes(), p
        assert server.buffer.version == 1
        if hasattr(client, "close"):
            client.close()
    finally:
        server.stop()


@pytest.mark.parametrize("mode", ["socket", "http"])
def test_wrong_key_is_refused_across_packages(mode):
    server = port_server(mode, TREE, port=0, auth_key=os.urandom(32), device="cpu")
    server.start()
    try:
        client = jax_client(mode, f"127.0.0.1:{server.port}", auth_key=os.urandom(32))
        with pytest.raises((ConnectionError, RuntimeError)):
            client.update_parameters(DELTA)
        assert server.buffer.version == 0
    finally:
        server.stop()
