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

The same world then runs the sharded engine's speculation (a self-draft
of 1 layer, gamma 2: ``"tp_spec"``), its KV handoff in every pairing
(``"tp_handoff"``) and its weight delivery through a ``WeightSubscriber``
(``"tp_rollout"``). Their oracle is the JAX package's engines sharded by
its ``shard_serving`` on a model axis of 2 of the virtual CPU devices,
built once for the module: its speculative streams, its sharded prefill
engine's exports, frames (imported by the port's sharded engine) and
decoded streams, and its streams after installing version 1's weights.
Streams equal the JAX engine's exactly unless the JAX model's top-2 gap
at the first difference is below 1e-4; exported K/V agree within 1e-5.
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
from elephas_tpu.parallel.mesh import build_mesh as jax_build_mesh
from elephas_tpu.parallel.tensor_parallel import decode_cache_specs as jax_decode_cache_specs
from elephas_tpu.serving import InferenceEngine as JaxEngine
from elephas_tpu.serving import handoff as jax_handoff
from elephas_tpu.serving import shard_serving as jax_shard_serving
from elephas_tpu.serving.scheduler import QueueFull as JaxQueueFull
from elephas_tpu_torch.api import CompiledModel
from elephas_tpu_torch.convert import from_flax_params, to_flax_params
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
SPEC = dict(speculative=True, gamma=2, draft_layers=1)
BLOCK = 4  # the handoff engines' KV block size: prompts span 1 or 2 blocks
HANDOFF_PROMPTS = PROMPTS + [[7, 2, 8, 4, 9, 9]]  # the last shares a block with the second
PAIRINGS = ("sharded_to_unsharded", "sharded_to_sharded", "unsharded_to_sharded",
            "jax_to_sharded")
NEAR_TIE = 1e-4  # JAX top-2 gap under which a stream may differ
KV_ERR = 1e-5    # max-abs limit of an exported K/V against another engine's
# chip_smoke's tensor-parallel (e)-(g) on this LM: 8 requests, all in
# flight at once (the rollout pushes once every one has 8 tokens).
SMOKE_ENGINE = {"max_slots": 8, "max_prompt_len": 8, "max_len": 48, "queue_depth": 16,
                "kv_block_size": 4, "prefill_chunk": 4, "prefill_chunks_per_step": 2,
                "prefix_cache": True}
SMOKE_TRAFFIC = [(p, 40) for p in HANDOFF_PROMPTS + [[9, 8, 7], [2, 2], [5, 3, 9, 1]]]


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


def import_all(engine, frames, queue_full):
    """Every frame through ``submit_handoff``, stepping the engine while
    its slots are all taken; the streams, in the frames' order."""
    ids = []
    for frame in frames:
        while True:
            try:
                ids.append(engine.submit_handoff(frame))
                break
            except queue_full:
                engine.step()
    return [engine.result(i, timeout_s=240).tokens for i in ids]


@pytest.fixture(scope="module")
def rollout_trees(jax_compiled):
    """(served weights, the delta pushed to the parameter server, version
    1 = served - delta as the server computes it, version 1 as flax
    params)."""
    module = get_model("transformer_lm", device="cpu", **LM)
    v0 = from_flax_params(jax.device_get(jax_compiled.params), module)
    gen = torch.Generator().manual_seed(2)
    delta = {k: 0.5 * v.abs().mean() * torch.randn(v.shape, generator=gen)
             for k, v in v0.items()}
    v1 = {k: v0[k] - delta[k] for k in v0}
    return v0, delta, v1, to_flax_params(v1, module)


@pytest.fixture(scope="module")
def jax_oracle(jax_compiled, rollout_trees):
    """The JAX package's engines sharded on a model axis of 2 of the
    virtual devices: speculative streams; a sharded prefill engine's
    exports and frames of HANDOFF_PROMPTS, and the streams its sharded
    decode engine makes of them; the streams after installing version 1."""
    mesh = jax_build_mesh(num_data=1, num_model=WORLD)

    def serve(engine, prompts=PROMPTS):
        ids = [engine.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
        return [list(engine.result(i, timeout_s=240).tokens) for i in ids]

    out = {"spec": serve(jax_shard_serving(JaxEngine(jax_compiled, **SPEC, **ENGINE), mesh))}
    pre = jax_shard_serving(JaxEngine(jax_compiled, kv_block_size=BLOCK, **ENGINE), mesh)
    handoffs = [pre.handoff(pre.submit_prefill(p, max_new_tokens=NEW_TOKENS), timeout_s=240)
                for p in HANDOFF_PROMPTS]
    out["exports"] = [h["export"] for h in handoffs]
    out["frames"] = [jax_handoff.encode_handoff(h).tobytes() for h in handoffs]
    dec = jax_shard_serving(JaxEngine(jax_compiled, kv_block_size=BLOCK, **ENGINE), mesh)
    out["handoff"] = [list(tokens) for tokens in import_all(dec, out["frames"], JaxQueueFull)]
    installed = jax_shard_serving(JaxEngine(jax_compiled, **ENGINE), mesh)
    installed.install_weights(rollout_trees[3], version=1)
    out["installed"] = serve(installed)
    out["installed_version"] = installed.model_version
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_compiled, jax_oracle, rollout_trees):
    """Every rank's results of each job of the spawned world, by kind."""
    tmp = tmp_path_factory.mktemp("serving_tp")
    module = get_model("transformer_lm", device="cpu", **LM)
    weights = from_flax_params(jax.device_get(jax_compiled.params), module)
    torch.save(weights, tmp / "lm.pt")
    gen = torch.Generator().manual_seed(1)
    torch.save({k: v + 0.2 * torch.randn(v.shape, generator=gen) for k, v in weights.items()},
               tmp / "installed.pt")
    torch.save(rollout_trees[1], tmp / "delta.pt")
    jax_frames = []
    for i, frame in enumerate(jax_oracle["frames"]):
        jax_frames.append(str(tmp / f"jax{i}.frame"))
        Path(jax_frames[-1]).write_bytes(frame)
    common = {"kwargs": LM, "weights": str(tmp / "lm.pt"), "engine": ENGINE,
              "prompts": PROMPTS, "new_tokens": NEW_TOKENS}
    jobs = [{**common, "kind": "tp_serving", "installed": str(tmp / "installed.pt")},
            {**common, "kind": "tp_spec", "gamma": SPEC["gamma"],
             "draft_layers": SPEC["draft_layers"]},
            {**common, "kind": "tp_handoff", "prompts": HANDOFF_PROMPTS, "block_size": BLOCK,
             "jax_frames": jax_frames},
            {**common, "kind": "tp_rollout", "delta": str(tmp / "delta.pt")},
            {**common, "kind": "tp_smoke_paths", "traffic": SMOKE_TRAFFIC,
             "overrides": {"SERVE_ENGINE": SMOKE_ENGINE, "SPEC_DRAFT_LAYERS": 1}}]
    for job in jobs:
        job["out"] = str(tmp / f"{job['kind']}.out")
    config = tmp / "config.json"
    config.write_text(json.dumps({"store": str(tmp / "store"), "world": WORLD, "jobs": jobs}))
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
    return {job["kind"]: [torch.load(f"{job['out']}.rank{r}", weights_only=False)
                          for r in range(WORLD)] for job in jobs}


@pytest.fixture(scope="module")
def served(world):
    return world["tp_serving"]


def _jax_top2_gap(jc, params, context):
    logits = np.asarray(jc.module.apply({"params": params},
                                        jnp.asarray([context], jnp.int32)))[0, -1]
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


def _assert_near_jax(jc, params, prompts, want, got):
    """``got`` equals the JAX engine's ``want`` stream for stream, unless
    the JAX model's top-2 gap at the first difference is below NEAR_TIE;
    returns the ties as (request, token, gap)."""
    ties = []
    assert len(want) == len(got)
    for i, (prompt, a, b) in enumerate(zip(prompts, want, got)):
        if list(a) == list(b):
            continue
        k = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        gap = _jax_top2_gap(jc, params, list(prompt) + list(a[:k]))
        assert gap < NEAR_TIE, f"request {i} differs from the JAX engine at token {k} " \
                               f"({a} vs {b}), JAX top-2 gap {gap}"
        ties.append((i, k, gap))
    return ties


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


def test_a_weight_subscriber_on_a_sharded_engine_installs_on_every_rank(world):
    """A ``WeightSubscriber`` attached before ``shard_serving`` is kept,
    and installs version 1 from the parameter server at the step boundary
    after the first request's first step: rank 0 broadcasts the whole
    tensors, every rank reports version 1, and the engine serves on."""
    rollout = world["tp_rollout"]
    assert rollout[0]["kept"] is True
    assert rollout[0]["version_after_first"] == 1 and rollout[0]["step_swaps"] == 1
    assert [rank["step_version"] for rank in rollout] == [1] * WORLD
    assert rollout[0]["step_messages"]["install"] == 1
    assert len(rollout[0]["first"][0]) == NEW_TOKENS


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


# -- speculation on the sharded engine ----------------------------------------------


def test_sharded_speculation_streams_equal_the_unsharded_engines(world):
    """The self-draft speculative engine sharded over 2 ranks gives the
    port's unsharded speculative engine's streams and its plain engine's,
    exactly."""
    rank0 = world["tp_spec"][0]
    assert rank0["streams"] == rank0["unsharded"] == rank0["plain"]
    assert all(len(s) == NEW_TOKENS for s in rank0["streams"])


def test_sharded_speculation_streams_equal_the_jax_sharded_engine(world, jax_compiled,
                                                                  jax_oracle):
    """The JAX speculative engine under its ``shard_serving`` (gamma 2, a
    1-layer self-draft): equal streams, unless the JAX top-2 gap is below
    1e-4 at the first difference; and both equal JAX's per-row
    ``generate``."""
    got = world["tp_spec"][0]["streams"]
    _assert_near_jax(jax_compiled, jax_compiled.params, PROMPTS, jax_oracle["spec"], got)
    for stream, prompt in zip(jax_oracle["spec"], PROMPTS):
        assert stream == _per_row(jax_compiled, prompt, NEW_TOKENS)


def test_sharded_speculation_builds_each_program_once_eagerly(world):
    stats = world["tp_spec"][0]["stats"]
    assert stats["draft_traces"] == stats["verify_traces"] == 1
    assert stats["draft_prefill_traces"] == 0 and stats["spec_fallbacks"] == 0
    assert stats["tensor_parallel"]["spec_graphs"] is False
    assert stats["tensor_parallel"]["decode_graph"] is False


def test_every_rank_runs_every_speculation_window(world):
    """Each window rank 0 drafts and verifies is one ``"spec"`` message,
    and every follower runs it: ``spec_windows`` and the draft and verify
    builds are equal on every rank."""
    ranks = world["tp_spec"]
    windows = {rank["stats"]["spec_windows"] for rank in ranks}
    assert len(windows) == 1 and windows.pop() > 0
    assert {rank["stats"]["tensor_parallel"]["messages"]["spec"] for rank in ranks} == \
        {ranks[0]["stats"]["spec_windows"]}
    assert all(rank["stats"]["verify_traces"] == 1 for rank in ranks)


def test_the_self_draft_view_holds_the_shards_heads(world):
    """``shard_serving`` binds the draft's layer view again after sharding:
    its head count is the shard's, as the target's is."""
    for rank in world["tp_spec"]:
        assert rank["heads"] == (LM["num_heads"] // WORLD,) * 2


# -- the KV handoff of the sharded engine -------------------------------------------


def _kv_err(a, b):
    return max(float(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).max())
               for x, y in zip(a, b))


def test_a_sharded_export_is_the_unsharded_engines(world):
    """The sharded prefill engine's exports carry every head of the model:
    the leaf names, shapes and block counts of the unsharded engine's
    export, and its K/V within 1e-5 max-abs."""
    rank0 = world["tp_handoff"][0]
    for sharded, unsharded in zip(rank0["sharded_exports"], rank0["unsharded_exports"]):
        assert sharded["leaves"] == unsharded["leaves"]
        assert sharded["blocks"] == unsharded["blocks"]
        assert sharded["block_size"] == unsharded["block_size"] == BLOCK
        assert [tuple(a.shape) for a in sharded["arrays"]] == \
            [tuple(a.shape) for a in unsharded["arrays"]]
        assert sharded["arrays"][0].shape[1] == LM["num_heads"]
        assert _kv_err(sharded["arrays"], unsharded["arrays"]) <= KV_ERR


def test_a_sharded_export_is_the_jax_sharded_engines(world, jax_oracle):
    """Against the JAX package's sharded prefill engine: the same leaf
    names and shapes, and K/V within 1e-5 max-abs."""
    for ours, theirs in zip(world["tp_handoff"][0]["sharded_exports"], jax_oracle["exports"]):
        assert ours["leaves"] == list(theirs["leaves"])
        assert [tuple(a.shape) for a in ours["arrays"]] == \
            [tuple(a.shape) for a in theirs["arrays"]]
        assert _kv_err(ours["arrays"], theirs["arrays"]) <= KV_ERR


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_handoff_streams_equal_a_single_engine(world, pairing):
    """After the import, the decode engine's streams are a single
    engine's, in every pairing with a sharded engine (the last prompt
    admits its first block from the decode engine's prefix cache)."""
    rank0 = world["tp_handoff"][0]
    assert rank0[pairing] == rank0["single"]


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_handoff_streams_equal_the_jax_sharded_engines(world, jax_compiled, jax_oracle,
                                                       pairing):
    _assert_near_jax(jax_compiled, jax_compiled.params, HANDOFF_PROMPTS,
                     jax_oracle["handoff"], world["tp_handoff"][0][pairing])


def test_the_sharded_decode_engine_reuses_a_resident_prefix(world):
    assert world["tp_handoff"][0]["dec_prefix_hits"] >= 1


def test_refused_frames_leave_the_decode_pool_unchanged_on_every_rank(world):
    """A corrupt frame, and a frame holding one rank's heads only, are
    refused on rank 0 before any message goes out: its free slots, free
    blocks and messages are unchanged, and the follower ran exactly the
    imports rank 0 sent."""
    ranks = world["tp_handoff"]
    refused = ranks[0]["refused"]
    assert refused["corrupt"].startswith("WireFormatError")
    assert refused["one_rank_heads"].startswith("ValueError") and "shape" in \
        refused["one_rank_heads"]
    before, after = ranks[0]["refused_pool"]
    assert before == after
    assert ranks[1]["dec_messages"] == ranks[0]["dec_messages"]
    assert ranks[1]["pre_messages"] == ranks[0]["pre_messages"]
    assert ranks[0]["dec_messages"]["import"] == 3 * len(HANDOFF_PROMPTS)
    assert ranks[0]["pre_messages"]["export"] == len(HANDOFF_PROMPTS)


def test_billed_tokens_of_the_two_tiers_sum_to_a_single_engine(world):
    """The prefill tier bills the prompt and the first token, the decode
    tier the rest: in each pairing their sums are the single engine's."""
    billed = world["tp_handoff"][0]["billed"]
    single = billed["single"]["sharded"]
    for pre, dec, tenant in (("pre", "to_unsharded", "sharded"), ("pre", "dec", "sharded"),
                             ("unsharded", "dec", "unsharded")):
        for key, total in single.items():
            assert billed[pre][tenant][key] + billed[dec][tenant][key] == total, \
                (pre, dec, key)


# -- weight delivery to the sharded engine -------------------------------------------


def test_streams_after_a_subscribed_install_are_version_1s(world, jax_compiled, jax_oracle,
                                                           rollout_trees):
    """After version 1 installs through the subscriber (at a step boundary
    or by a nudge), the sharded engines serve the unsharded engine's
    streams on version 1's weights, and the JAX sharded engine's after its
    ``install_weights`` (up to near-ties)."""
    rank0 = world["tp_rollout"][0]
    assert rank0["pulled_version"] == 1 == jax_oracle["installed_version"]
    assert rank0["step"] == rank0["nudge"] == rank0["plain"]
    assert rank0["step"] != world["tp_serving"][0]["paged"]
    _assert_near_jax(jax_compiled, rollout_trees[3], PROMPTS, jax_oracle["installed"],
                     rank0["step"])


def test_nudge_installs_on_an_idle_sharded_engine(world):
    """With no traffic, ``nudge`` gives the sharded engine a step boundary:
    the followers, waiting in ``follow()``, take the install, and every
    rank reports version 1."""
    rollout = world["tp_rollout"]
    assert rollout[0]["nudged"] is True and rollout[0]["version_after_nudge"] == 1
    assert rollout[0]["nudge_swaps"] == 1
    assert [rank["nudge_version"] for rank in rollout] == [1] * WORLD


# -- chip_smoke's tensor-parallel serving paths ----------------------------------------


def test_the_chip_smoke_serving_paths_pass_on_the_cpu(world):
    """``chip_smoke.tp_serving_paths`` ((e) speculation, (f) the handoff
    both ways, (g) a rollout) on this LM over 2 ranks: every check of the
    script passes, and its report holds what the phase prints."""
    ranks = world["tp_smoke_paths"]
    rank0 = ranks[0]
    spec = rank0["serving_spec"]
    assert spec["builds"] == [1, 1] and spec["requests"] == len(SMOKE_TRAFFIC)
    assert spec["streams"]["identical"] + len(spec["streams"]["near_ties"]) == len(SMOKE_TRAFFIC)
    assert [rank["spec_windows"] for rank in ranks] == [spec["windows"]] * WORLD
    handoff = rank0["serving_handoff"]
    assert handoff["kv_worst_of_limit"] <= 1.0 and handoff["frame_bytes_max"] > 0
    assert handoff["messages"]["prefill"]["export"] == handoff["messages"]["decode"][
        "import"] == len(SMOKE_TRAFFIC)
    assert [rank["rollout_version"] for rank in ranks] == [1] * WORLD
    assert rank0["serving_rollout"]["changed"] > 0 and rank0["serving_rollout"]["install_ms"] > 0
    assert set(rank0["ms"]) == {"serving_spec", "serving_handoff", "serving_rollout"}
