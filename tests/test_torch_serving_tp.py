"""Tensor-parallel serving (``InferenceEngine.shard_serving``) in the port
against its unsharded engine and the JAX package's, on the CPU.

The JAX reference test's model (``tests/test_serving_tp.py``: vocab 64,
d_model 32, 4 heads, 2 layers, max_seq_len 64, seed 0) is carried across
with ``convert.from_flax_params``. The port serves its prompt matrix from
an engine sharded over a model axis of 2, as two gloo processes
(``tests/test_torch_dist_worker.py``'s ``"tp_serving"`` job: rank 0
serves, rank 1 follows), from the paged and the contiguous pool, and
serves them again from the paged engine after rank 0 installed other
weights (``install_weights`` sends them to the followers). Greedy
streams must equal the port's unsharded engine's and the JAX plain
engine's per-row ``generate`` streams (the JAX sharded engine's streams
equal those too; its compile count under the mesh is the reference's own
red test, which the port does not take as an oracle).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.api.compile import CompiledModel as JaxCompiledModel
from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu.parallel.tensor_parallel import decode_cache_specs as jax_decode_cache_specs
from elephas_tpu_torch.api import CompiledModel
from elephas_tpu_torch.convert import from_flax_params
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh
from elephas_tpu_torch.parallel.tensor_parallel import P, decode_cache_specs
from elephas_tpu_torch.serving import InferenceEngine, shard_serving
from tests.test_serving import _per_row

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "test_torch_dist_worker.py"
LM = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, max_seq_len=64)
ENGINE = dict(max_slots=2, max_prompt_len=8, max_len=24)
PROMPTS = [[5, 3, 9], [7, 2, 8, 4, 1, 6], [11, 12], [1, 2, 3, 4]]  # test_serving_tp.py:82
NEW_TOKENS = 6
WORLD = 2
POOLS = ("paged", "contiguous")


@pytest.fixture(scope="module")
def jax_compiled():
    return JaxCompiledModel(jax_get_model("transformer_lm", **LM),
                            optimizer={"name": "adam", "learning_rate": 3e-3},
                            loss="sparse_categorical_crossentropy", metrics=[],
                            input_shape=(LM["max_seq_len"],), input_dtype=jnp.int32, seed=0)


def _port(jax_compiled):
    module = get_model("transformer_lm", device="cpu", **LM)
    return CompiledModel(module, from_flax_params(jax.device_get(jax_compiled.params), module),
                         optimizer="adam", loss="sparse_categorical_crossentropy", metrics=[])


@pytest.fixture(scope="module")
def served(tmp_path_factory, jax_compiled):
    """Every rank's results of the spawned world (rank 0's streams)."""
    tmp = tmp_path_factory.mktemp("serving_tp")
    module = get_model("transformer_lm", device="cpu", **LM)
    weights = from_flax_params(jax.device_get(jax_compiled.params), module)
    torch.save(weights, tmp / "lm.pt")
    gen = torch.Generator().manual_seed(1)
    torch.save({k: v + 0.2 * torch.randn(v.shape, generator=gen) for k, v in weights.items()},
               tmp / "installed.pt")
    job = {"kind": "tp_serving", "kwargs": LM, "weights": str(tmp / "lm.pt"),
           "installed": str(tmp / "installed.pt"), "engine": ENGINE, "prompts": PROMPTS,
           "new_tokens": NEW_TOKENS, "out": str(tmp / "serve.out")}
    config = tmp / "config.json"
    config.write_text(json.dumps({"store": str(tmp / "store"), "world": WORLD, "jobs": [job]}))
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "GLOO_SOCKET_IFNAME": "lo"}
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(config), str(r)], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT, cwd=ROOT)
             for r in range(WORLD)]
    try:
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    assert codes == [0] * WORLD, [(tmp / f"rank{r}.log").read_text()[-3000:]
                                  for r in range(WORLD)]
    return [torch.load(f"{job['out']}.rank{r}", weights_only=False) for r in range(WORLD)]


# -- decode_cache_specs -----------------------------------------------------------


def test_decode_cache_specs_of_the_jax_layout():
    """On the JAX package's nested cache layout the port's specs are its:
    K/V leaves head-sharded, index leaves replicated."""
    cache = {"layer": {"attn": {"cached_key": np.zeros((3, 4, 16, 8)),
                                "cached_value": np.zeros((3, 4, 16, 8)),
                                "cache_index": np.zeros((3,), np.int32)},
                       "pos_index": np.zeros((3,), np.int32)}}
    got = decode_cache_specs(cache)
    want = jax_decode_cache_specs({k: jax.tree_util.tree_map(jnp.asarray, v)
                                   for k, v in cache.items()})
    assert tuple(got["layer"]["attn"]["cached_key"]) == \
        tuple(want["layer"]["attn"]["cached_key"]) == (None, MODEL_AXIS, None, None)
    assert tuple(got["layer"]["attn"]["cache_index"]) == tuple(want["layer"]["attn"]
                                                               ["cache_index"]) == ()
    assert tuple(got["layer"]["pos_index"]) == ()


@pytest.mark.parametrize("pool", POOLS)
def test_decode_cache_specs_of_the_port_pools(jax_compiled, pool):
    engine = InferenceEngine(_port(jax_compiled), paged=pool == "paged", **ENGINE)
    specs = decode_cache_specs(engine.pool.cache)
    assert specs.keys == specs.values == [P(None, MODEL_AXIS, None, None)] * LM["num_layers"]
    assert specs.index == P()


# -- the sharded engine ---------------------------------------------------------------


@pytest.mark.parametrize("pool", POOLS)
def test_sharded_streams_equal_the_unsharded_engine(served, pool):
    """Ragged prompts, slot reuse (4 requests over 2 slots), mid-decode
    admission: the same tokens from the engine sharded over 2 ranks as
    from the port's unsharded engine."""
    assert served[0][pool] == served[0][f"{pool}_plain"]
    assert all(len(s) == NEW_TOKENS for s in served[0][pool])


@pytest.mark.parametrize("pool", POOLS)
def test_sharded_streams_equal_jax_per_row(served, jax_compiled, pool):
    """The same streams as the JAX plain engine's oracle: per-row
    ``generate``."""
    for got, prompt in zip(served[0][pool], PROMPTS):
        assert got == _per_row(jax_compiled, prompt, NEW_TOKENS)


@pytest.mark.parametrize("pool", POOLS)
def test_each_rank_pool_holds_its_heads(served, pool):
    for rank in served:
        for shape in rank[f"{pool}_kv_heads"]:
            assert shape[1] == LM["num_heads"] // WORLD


def test_stats_report_the_eager_decode_step(served):
    for pool in POOLS:
        stats = served[0][f"{pool}_stats"]
        assert stats["tensor_parallel"]["model"] == WORLD
        assert stats["tensor_parallel"]["decode_graph"] is False
        assert "gloo" in stats["tensor_parallel"]["why"]
        assert stats["prefill_traces"] == stats["decode_traces"] == 1


def test_installed_weights_reach_every_rank(served):
    """Rank 0's ``install_weights`` on the sharded engine: the followers
    install their shards of the same tensors, so the streams change, and
    equal the unsharded engine's on the installed weights."""
    assert served[0]["installed"] == served[0]["installed_plain"]
    assert served[0]["installed"] != served[0]["paged"]
    assert [rank["paged_version"] for rank in served] == [7] * WORLD


def test_a_weight_subscriber_on_a_sharded_engine_is_not_ported_yet(served):
    """Attaching a weight subscriber to a sharded engine raises naming
    ROADMAP item 7a's sharded left-outs, before any step lock is taken:
    the engine then serves as before."""
    assert "ROADMAP item 7a, sharded left-outs" in served[0]["subscriber_refused"]
    assert served[0]["paged"] == served[0]["paged_plain"]


def test_shard_serving_refuses_a_warm_engine(jax_compiled):
    engine = InferenceEngine(_port(jax_compiled), **ENGINE)
    engine.result(engine.submit([5, 3, 9], max_new_tokens=2), timeout_s=60)
    with pytest.raises(RuntimeError, match="before the first request"):
        engine.shard_serving(Mesh(model_size=2))


def test_shard_serving_refuses_indivisible_heads(jax_compiled):
    """4 heads over a model axis of 8: a loud error naming num_heads."""
    engine = InferenceEngine(_port(jax_compiled), **ENGINE)
    with pytest.raises(ValueError, match="num_heads"):
        shard_serving(engine, Mesh(model_size=8))


@pytest.mark.parametrize("mesh", [Mesh(size=2, model_size=2), Mesh(seq_size=2, model_size=2)])
def test_shard_serving_refuses_data_and_seq_axes(jax_compiled, mesh):
    """One process per device: a data (or seq) axis above 1 would run
    copies of the same serving program, so the layout is refused (a
    deliberate difference from the JAX package, whose GSPMD copies compute
    the same tokens again)."""
    engine = InferenceEngine(_port(jax_compiled), **ENGINE)
    with pytest.raises(ValueError, match="data 1 x seq 1"):
        engine.shard_serving(mesh)


def test_shard_serving_needs_the_model_axis_to_span_the_world(jax_compiled):
    engine = InferenceEngine(_port(jax_compiled), **ENGINE)
    with pytest.raises(ValueError, match="span the world"):
        engine.shard_serving(Mesh(model_size=2))
    assert engine.shard_serving(Mesh()) is engine  # a model axis of 1 shards nothing
    with pytest.raises(RuntimeError, match="follow"):
        engine.follow()
    engine.close()  # not sharded: nothing to release
