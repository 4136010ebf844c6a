"""The port's checkpoints (``models/checkpoint.py``) and the server's
``load_params`` from them, twins of the reference's
``tests/test_checkpoint.py`` and ``tests/test_serving_server.py``'s
``test_load_params_from_train_checkpoint``.

The port cannot read orbax, so these pin the port's own round trip on the
reference's weights (``params_from_jax``) in f32 on the CPU: a restore
equals what was saved bit for bit (dtypes and devices kept); training
resumed from a checkpoint equals the uninterrupted run bit for bit;
cadence, retention and the atomic commit behave as orbax's; a save
returns only once the state is copied, so the train step's in-place
update cannot reach a checkpoint being written; moments are matched by
leaf name. ``tests/test_torch_trainer.py`` holds a resumed ``Trainer``
against the JAX ``Trainer``.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_torch.models import checkpoint as tckpt
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models import train as ttrain
from k8s_gpu_device_plugin_torch.models.batching import ContinuousBatcher
from k8s_gpu_device_plugin_torch.models.checkpoint import (
    TrainCheckpointer,
    abstract_like,
)
from k8s_gpu_device_plugin_torch.models.convert import params_from_jax
from k8s_gpu_device_plugin_torch.models.generate import generate
from k8s_gpu_device_plugin_torch.serving import server as srv
from k8s_gpu_device_plugin_tpu.models import llama as jllama

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    np_params = jax.tree.map(np.asarray,
                             jllama.init_params(jax.random.key(0), jcfg))
    optimizer = ttrain.make_optimizer(learning_rate=1e-2, warmup_steps=1,
                                      total_steps=10)

    # the train step updates its state IN PLACE, so every test takes a
    # fresh state from this factory
    def make_state():
        return ttrain.init_train_state(
            cfg, optimizer, device="cpu",
            params=params_from_jax(np_params, cfg, device="cpu"))

    step_fn = ttrain.make_train_step(cfg, optimizer)
    batch = ttrain.synthetic_batch(cfg, 4, 32, seed=1, device="cpu")
    return cfg, optimizer, make_state, step_fn, batch


def _leaves(state):
    return (ttrain.param_leaves(state["params"]) + state["opt_state"]["mu"]
            + state["opt_state"]["nu"])


def _equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return (len(la) == len(lb) and all(torch.equal(x, y)
                                       for x, y in zip(la, lb))
            and a["step"] == b["step"]
            and a["opt_state"]["count"] == b["opt_state"]["count"])


def _snapshot(state):
    return {"params": {k: ({kk: vv.clone() for kk, vv in v.items()}
                           if isinstance(v, dict) else v.clone())
                       for k, v in state["params"].items()},
            "opt_state": {"count": state["opt_state"]["count"],
                          "mu": [m.clone() for m in state["opt_state"]["mu"]],
                          "nu": [m.clone() for m in state["opt_state"]["nu"]]},
            "step": state["step"]}


def test_save_restore_round_trip_keeps_dtypes_and_devices(tmp_path, setup):
    _, _, make_state, step_fn, batch = setup
    state, _ = step_fn(make_state(), batch)
    with TrainCheckpointer(str(tmp_path / "ckpt"), save_interval=1) as ckpt:
        assert ckpt.save(state)
        ckpt.wait()
        assert ckpt.latest_step() == 1
        restored = ckpt.restore(abstract_like(state))
        assert sorted(os.listdir(tmp_path / "ckpt" / "1")) == [
            "meta.json", "opt_state.pt", "params.pt", "step.pt"]
    assert _equal(state, restored)
    for a, b in zip(_leaves(state), _leaves(restored)):
        assert (a.dtype, a.device) == (b.dtype, b.device)
        assert a.data_ptr() != b.data_ptr()  # a new state, not the old

    # mixed dtypes, and a view: the file holds the view's elements, not
    # its base's whole storage
    base = torch.arange(4096, dtype=torch.float32).reshape(64, 64)
    mixed = {"params": {"w": torch.ones(3, 5, dtype=torch.bfloat16),
                        "q": {"codes": torch.arange(6, dtype=torch.int8),
                              "view": base[:2, :3]}},
             "step": 7}
    with TrainCheckpointer(str(tmp_path / "mixed"), async_save=False) as ckpt:
        assert ckpt.save(mixed, force=True)
        back = ckpt.restore(mixed)
        raw = ckpt.restore_unstructured(keys=("params",))
    assert set(raw) == {"params"}
    for a, b in ((mixed["params"]["w"], back["params"]["w"]),
                 (mixed["params"]["q"]["codes"], back["params"]["q"]["codes"]),
                 (mixed["params"]["q"]["view"], back["params"]["q"]["view"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert back["step"] == 7
    assert os.path.getsize(tmp_path / "mixed" / "7" / "params.pt") < \
        base.numel() * base.element_size()


def test_resume_continues_bit_identically(tmp_path, setup):
    """Four steps straight through against two, a save, a fresh state
    resumed from the checkpoint, and two more: losses, parameters and
    moments equal bit for bit."""
    _, _, make_state, step_fn, batch = setup
    straight, losses = make_state(), []
    for _ in range(4):
        straight, m = step_fn(straight, batch)
        losses.append(float(m["loss"]))

    s = make_state()
    for _ in range(2):
        s, _ = step_fn(s, batch)
    with TrainCheckpointer(str(tmp_path / "ckpt"), save_interval=1) as ckpt:
        assert ckpt.save(s)
        ckpt.wait()
        del s
        resumed, was_resumed = ckpt.restore_or_pass(make_state())
        assert was_resumed and resumed["step"] == 2
        assert ckpt.last_restore["step"] == 2
    got = []
    for _ in range(2):
        resumed, m = step_fn(resumed, batch)
        got.append(float(m["loss"]))
    assert got == losses[2:]
    assert _equal(straight, resumed)


def test_restore_or_pass_without_checkpoint(tmp_path, setup):
    _, _, make_state, _, _ = setup
    state = make_state()
    with TrainCheckpointer(str(tmp_path / "empty")) as ckpt:
        out, resumed = ckpt.restore_or_pass(state)
        assert not resumed
        assert out is state
        with pytest.raises(FileNotFoundError):
            ckpt.restore(abstract_like(state))


def test_retention_and_cadence(tmp_path, setup):
    _, _, make_state, step_fn, batch = setup
    with TrainCheckpointer(str(tmp_path / "keep"), max_to_keep=2,
                           save_interval=2) as ckpt:
        s = make_state()
        saved = []
        for _ in range(5):
            s, _ = step_fn(s, batch)
            saved.append(ckpt.save(s))
        ckpt.wait()
        # cadence 2 => steps 2 and 4 saved (1, 3, 5 skipped); retention
        # 2 keeps both
        assert saved == [False, True, False, True, False]
        assert ckpt.all_steps() == [2, 4]
        # a step already on disk is not written again, forced or not
        assert not ckpt.save(s, step=4, force=True)
        # force overrides cadence
        assert ckpt.save(s, force=True)
        ckpt.wait()
        assert ckpt.latest_step() == 5
        assert ckpt.all_steps() == [4, 5]  # retention pruned the oldest
    assert sorted(os.listdir(tmp_path / "keep")) == ["4", "5"]


def test_partial_write_is_invisible(tmp_path, setup, monkeypatch):
    """A step is listed once its directory is committed whole: neither a
    temporary directory nor a step directory without its meta file is
    one, and a write that fails leaves nothing behind."""
    _, _, make_state, _, _ = setup
    d = tmp_path / "ckpt"
    (d / ".tmp-7-partial").mkdir(parents=True)
    (d / ".tmp-7-partial" / "params.pt").write_bytes(b"half")
    (d / "9").mkdir()
    ckpt = TrainCheckpointer(str(d), async_save=False, save_interval=1)
    assert ckpt.all_steps() == [] and ckpt.latest_step() is None
    state = make_state()
    assert ckpt.restore_or_pass(state) == (state, False)

    real_save = torch.save

    def fail_on_moments(obj, path, *a, **kw):
        if str(path).endswith("opt_state.pt"):
            raise OSError("disk full")
        return real_save(obj, path, *a, **kw)

    monkeypatch.setattr(tckpt.torch, "save", fail_on_moments)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save(state, step=3)
    assert ckpt.all_steps() == []
    assert sorted(os.listdir(d)) == [".tmp-7-partial", "9"]
    # the async writer's failure surfaces at wait()
    async_ckpt = TrainCheckpointer(str(d), save_interval=1)
    assert async_ckpt.save(state, step=3)
    with pytest.raises(OSError, match="disk full"):
        async_ckpt.wait()
    assert async_ckpt.all_steps() == []


def test_async_save_holds_the_saved_step_not_the_next(tmp_path, setup,
                                                      monkeypatch):
    """The train step updates the state in place. A save at step 2 whose
    write is still running while step 3 runs must restore step 2."""
    _, _, make_state, step_fn, batch = setup
    s = make_state()
    for _ in range(2):
        s, _ = step_fn(s, batch)
    want = _snapshot(s)
    release = threading.Event()
    real_save = torch.save

    def held(obj, path, *a, **kw):
        assert release.wait(60)
        return real_save(obj, path, *a, **kw)

    monkeypatch.setattr(tckpt.torch, "save", held)
    with TrainCheckpointer(str(tmp_path / "ckpt"), save_interval=1) as ckpt:
        assert ckpt.save(s)            # returns with the write held
        s, _ = step_fn(s, batch)       # step 3, in place, mid-write
        assert s["step"] == 3 and not _equal(s, want)
        assert ckpt.all_steps() == []  # nothing committed yet
        release.set()
        ckpt.wait()
        assert ckpt.all_steps() == [2]
        assert _equal(ckpt.restore(abstract_like(s)), want)


def test_moments_are_matched_by_leaf_name(tmp_path, setup):
    """Moments are written under their leaves' names: a target whose
    parameter dict lists its leaves in another order gets each leaf's own
    moments, and a target with other leaves is refused."""
    _, _, make_state, step_fn, batch = setup
    s, _ = step_fn(make_state(), batch)
    with TrainCheckpointer(str(tmp_path / "ckpt"), async_save=False,
                           save_interval=1) as ckpt:
        ckpt.save(s)
        raw = ckpt.restore_unstructured()
        assert set(raw["opt_state"]["mu"]) == set(
            tckpt.leaf_names(s["params"]))
        names = tckpt.leaf_names(s["params"])
        flipped = dict(reversed(list(s["params"].items())))
        order = tckpt.leaf_names(flipped)
        assert order != names
        mu = dict(zip(names, s["opt_state"]["mu"]))
        nu = dict(zip(names, s["opt_state"]["nu"]))
        target = {**s, "params": flipped,
                  "opt_state": {**s["opt_state"],
                                "mu": [torch.zeros_like(mu[n]) for n in order],
                                "nu": [torch.zeros_like(nu[n]) for n in order]}}
        back = ckpt.restore(target)
        for name, m, v in zip(order, back["opt_state"]["mu"],
                              back["opt_state"]["nu"]):
            assert torch.equal(m, mu[name]) and torch.equal(v, nu[name]), name
        fewer = {k: v for k, v in s["params"].items() if k != "lm_head"}
        with pytest.raises(ValueError, match="lm_head"):
            ckpt.restore({**s, "params": fewer,
                          "opt_state": {**s["opt_state"],
                                        "mu": s["opt_state"]["mu"][:-1],
                                        "nu": s["opt_state"]["nu"][:-1]}})


def test_load_params_from_train_checkpoint(tmp_path, setup):
    """Serving round trip with the port's own checkpoints: train a couple
    of steps with checkpointing on, then ``load_params`` restores the
    trained params (not a random draw) for the engine, and the engine's
    greedy stream equals ``generate`` on the same params."""
    cfg, _, make_state, step_fn, batch = setup
    state = make_state()
    for _ in range(2):
        state, _ = step_fn(state, batch)
    with TrainCheckpointer(str(tmp_path), async_save=False,
                           save_interval=1) as ckpt:
        assert ckpt.save(state, step=2, force=True)

    params = srv.load_params(cfg, str(tmp_path), device="cpu")
    got, want = (ttrain.param_leaves(params),
                 ttrain.param_leaves(state["params"]))
    assert len(got) == len(want) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="the config wants"):
        srv.load_params(tllama.LlamaConfig.tiny(dtype=torch.float32,
                                                n_layers=1),
                        str(tmp_path), device="cpu")
    prompt = np.random.default_rng(230).integers(1, cfg.vocab_size,
                                                 5).tolist()
    oracle = generate(params, torch.tensor([prompt]), cfg, 3)[0].tolist()
    engine = srv.InferenceEngine(ContinuousBatcher(
        params, cfg, n_slots=1, max_len=32, chunked_prefill=8))
    try:
        _, q = engine.submit(prompt, 3)
        toks = []
        while (item := q.get(timeout=120)) is not None:
            toks.append(item[0])
    finally:
        engine.shutdown()
    assert toks == oracle


def test_server_serves_what_the_trainer_saved(tmp_path):
    """The trainer's ``--checkpointDir`` feeds the server's: the target
    from ``--checkpointDir``, the speculative draft from
    ``--draftCheckpointDir`` (a self-draft from the same directory shares
    the target's tensors; from another, or beside random target weights,
    it is loaded). A checkpoint serves at its own depth (a run trained at
    a cut depth at that depth); a draft directory without a draft
    refuses."""
    from k8s_gpu_device_plugin_torch.models import trainer as ttrainer

    run = str(tmp_path / "run")
    assert ttrainer._main(["--preset", "tiny", "--steps", "2", "--seqLen",
                           "16", "--batchSize", "2", "--checkpointDir", run,
                           "--device", "cpu"]) == 0
    want = ttrain.param_leaves(TrainCheckpointer(run).restore_unstructured(
        keys=("params",))["params"])
    base = ["--device", "cpu", "--preset", "tiny", "--port", "0", "--host",
            "127.0.0.1", "--maxLen", "64", "--chunkedPrefill", "8",
            "--attributionOff", "--draftPreset", "tiny"]

    def served(extra):
        server = srv.build_server(srv.build_parser().parse_args(base + extra))
        server.start()
        server.stop()
        cb = server.engine.cb
        return (ttrain.param_leaves(cb.params),
                ttrain.param_leaves(cb.draft_params))

    def equal(got):
        return len(got) == len(want) and all(
            torch.equal(a, b) for a, b in zip(got, want))

    target, draft = served(["--checkpointDir", run,
                            "--draftCheckpointDir", run])
    assert equal(target) and equal(draft)
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(target, draft))
    target, draft = served(["--draftCheckpointDir", run, "--seed", "9"])
    assert equal(draft) and not equal(target)
    parser = srv.build_parser()
    with pytest.raises(ValueError, match="needs --draftPreset"):
        srv.build_server(parser.parse_args(
            ["--device", "cpu", "--preset", "tiny", "--draftCheckpointDir",
             run]))
    # a checkpoint one layer deep serves one layer deep, the target's and
    # the draft's configs both read off it
    cut = str(tmp_path / "cut")
    cfg1 = tllama.LlamaConfig.tiny(n_layers=1)
    with TrainCheckpointer(cut, async_save=False) as ckpt:
        ckpt.save({"params": tllama.init_params(cfg1, seed=3,
                                                device="cpu")},
                  step=1, force=True)
    server = srv.build_server(parser.parse_args(
        base + ["--checkpointDir", cut, "--draftCheckpointDir", cut]))
    server.start()
    server.stop()
    assert server.engine.cb.cfg.n_layers == 1
    assert server.engine.cb.draft_cfg.n_layers == 1


@pytest.mark.parametrize("weight_quant", ["none", "int8", "int4"])
def test_load_params_quantizes_moe_experts_as_drawn(tmp_path, weight_quant):
    """A MoE checkpoint's expert stacks are quantized one layer at a time
    on their way to the device: the tree equals the whole float tree
    quantized after, bit for bit."""
    from k8s_gpu_device_plugin_torch.models.quantized_serving import (
        quantize_weights,
    )

    cfg = tllama.LlamaConfig.tiny(n_experts=4, n_experts_per_token=2)
    params = tllama.init_params(cfg, seed=0, device="cpu")
    with TrainCheckpointer(str(tmp_path), async_save=False) as ckpt:
        ckpt.save({"params": params}, step=1, force=True)
    got = srv.load_params(cfg, str(tmp_path), device="cpu",
                          weight_quant=weight_quant)
    want = quantize_weights(params, weight_quant)
    assert tckpt.leaf_names(got) == tckpt.leaf_names(want)
    for a, b in zip(ttrain.param_leaves(got), ttrain.param_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if weight_quant != "none":
        assert isinstance(got["layers"]["moe_w1"], dict)
