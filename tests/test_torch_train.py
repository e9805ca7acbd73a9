"""Port parity, the LM training path: ``repro_torch.train`` (optimizer,
train step, checkpoint, data, fault tolerance), ``repro_torch.
distributed_lm`` and ``repro_torch.launch.train`` on the CPU.

The first group mirrors ``tests/test_train_infra.py`` (and the reference's
``test_smoke_train_step``) on the port: the loss decreases, the 8-bit
optimizer trains, quantize round-trips, checkpoints are atomic and prune
to keep-k, a restart resumes identically (rtol 1e-5, atol 1e-6, the
reference's), a preemption saves and exits, the ZeRO-1 specs, dedup.
The second holds the port to the reference on the same inputs: int8
codes equal and scales at 1e-7, ``lr_schedule`` at every step, one
``adam_update`` (float32 and 8-bit) at 1e-6, one train step, dedup's
``kept`` / ``comp`` equal, the compressed all-reduce, the spec and
struct trees, and checkpoints written by either package restored by the
other."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.distributed_lm.sharding as ref_sharding
import repro.models as ref_models
import repro.train as ref_train
import repro.train.optimizer as ref_opt
from repro.launch.mesh import make_test_mesh as ref_test_mesh
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.core.mesh import make_mesh
from repro_torch.distributed_lm import compressed_allreduce
from repro_torch.distributed_lm import sharding as port_sharding
from repro_torch.launch import train as port_launch_train
from repro_torch.models import build_model
from repro_torch.models.layers import P
from repro_torch.train import (AdamConfig, SupervisorConfig, SyntheticStream,
                               TrainSupervisor, adam_init, adam_update,
                               checkpoint as ckpt, dedup_corpus,
                               dequantize_blockwise, lr_schedule,
                               make_eval_step, make_train_step, model_params,
                               opt_state_specs, quantize_blockwise,
                               zero1_specs)
from repro_torch.train import optimizer as port_opt

_RESTART_TOL = dict(rtol=1e-5, atol=1e-6)    # tests/test_train_infra.py:122
_F32_TOL = dict(rtol=1e-4, atol=1e-4)        # tests/test_models.py:162


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _setup(arch="qwen3_1_7b", lr=3e-3, steps=40, use_8bit=False, micro=2,
           seed=0, **over):
    cfg = dataclasses.replace(get_smoke_config(arch), microbatch=micro,
                              opt_8bit=use_8bit, **over)
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(seed))
    opt_cfg = AdamConfig(lr=lr, use_8bit=use_8bit, total_steps=steps,
                         warmup_steps=4)
    params = model_params(model)
    opt = adam_init(params, opt_cfg)
    step = make_train_step(model, cfg, opt_cfg)
    return cfg, model, params, opt, step


def _snapshot(params):
    return {k: p.detach().clone() for k, p in params.items()}


# ---------------------------------------------------------------------------
# mirrors of tests/test_train_infra.py
# ---------------------------------------------------------------------------

def test_loss_decreases():
    cfg, model, params, opt, step = _setup(steps=30)
    it = iter(SyntheticStream(cfg, batch=4, seq=32, seed=0))
    losses = []
    for _ in range(30):
        params, opt, m = step(params, opt, next(it))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_8bit_optimizer_trains():
    cfg, model, params, opt, step = _setup(use_8bit=True, steps=25, lr=2e-3)
    assert opt["m"]["embed"]["codes"].dtype == torch.int8
    it = iter(SyntheticStream(cfg, batch=4, seq=32, seed=1))
    losses = []
    for _ in range(25):
        params, opt, m = step(params, opt, next(it))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_quantize_roundtrip():
    rng = np.random.default_rng(0)
    for shape in [(10,), (33, 7), (4, 5, 6)]:
        x = _t(rng.normal(size=shape).astype(np.float32))
        codes, scale = quantize_blockwise(x, block=16)
        back = dequantize_blockwise(codes, scale, shape)
        err = float((back - x).abs().max())
        assert err <= float(scale.max()) * 0.51 + 1e-7


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    cfg, model, params, opt, step = _setup()
    d = str(tmp_path / "ck")
    tree = ckpt.state_tree(params, opt)
    ckpt.save(d, 3, tree)
    ckpt.save(d, 7, tree)
    assert ckpt.latest_step(d) == 7
    assert not [n for n in os.listdir(d) if n.startswith(".tmp_")]
    s, back, meta = ckpt.restore(d, ckpt.state_like(params, opt))
    assert s == 7 and meta["step"] == 7
    flat_back = convert.lm_layers_from_params(back["params"])
    for k, p in params.items():
        np.testing.assert_array_equal(flat_back[k], p.detach().numpy())
    for stp in (8, 9, 10, 11):
        ckpt.save(d, stp, tree, keep=2)
    assert ckpt.all_steps(d) == [10, 11]


def test_restart_resumes_identically(tmp_path):
    """Train 10 steps with a checkpoint at 5; resume from 5 in a fresh
    model (other initial weights) and replay the stream from batch 5: the
    parameters end equal to the uninterrupted run's."""
    d = str(tmp_path / "ck")

    def make(seed):
        cfg, model, params, opt, step = _setup(steps=10, seed=seed)
        data = iter(SyntheticStream(cfg, batch=4, seq=32, seed=7))
        return params, opt, step, data

    params, opt, step, data = make(0)
    sup = TrainSupervisor(SupervisorConfig(ckpt_dir=d, ckpt_every=5,
                                           max_steps=10,
                                           handle_sigterm=False),
                          step, data, async_ckpt=False)
    _, p_full, _, _ = sup.run(params, opt)
    assert ckpt.all_steps(d) == [5, 10]

    params2, opt2, step2, data2 = make(1)
    for _ in range(5):
        next(data2)                      # stream position after step 5
    sup2 = TrainSupervisor(SupervisorConfig(ckpt_dir=d, ckpt_every=100,
                                            max_steps=10,
                                            handle_sigterm=False),
                           step2, data2, async_ckpt=False)
    _, tree, _ = ckpt.restore(d, ckpt.state_like(params2, opt2), step=5)
    ckpt.load_state(tree, params2, opt2)
    assert int(opt2["count"]) == 5
    _, p_resumed, _, log2 = sup2.run(params2, opt2, start_step=5)
    assert [m["step"] for m in log2] == [6, 7, 8, 9, 10]
    for k in p_full:
        np.testing.assert_allclose(p_resumed[k].detach().numpy(),
                                   p_full[k].detach().numpy(),
                                   **_RESTART_TOL, err_msg=k)


def test_resume_or_init_restores_the_newest_checkpoint(tmp_path):
    d = str(tmp_path / "ck")
    cfg, model, params, opt, step = _setup(steps=4)
    data = iter(SyntheticStream(cfg, batch=4, seq=32, seed=2))
    sup = TrainSupervisor(SupervisorConfig(ckpt_dir=d, ckpt_every=2,
                                           max_steps=4,
                                           handle_sigterm=False),
                          step, data)          # asynchronous writer
    _, p_end, o_end, _ = sup.run(params, opt)
    want = _snapshot(p_end)
    _, _, params2, opt2, _ = _setup(steps=4, seed=5)
    sup2 = TrainSupervisor(SupervisorConfig(ckpt_dir=d, max_steps=4,
                                            handle_sigterm=False),
                           step, data, async_ckpt=False)
    assert sup2.resume_or_init(params2, opt2)[0] == 4
    for k in want:
        assert torch.equal(params2[k], want[k]), k
        assert torch.equal(opt2["m"][k], o_end["m"][k]), k
    assert int(opt2["count"]) == 4


def test_preemption_saves_and_exits(tmp_path):
    d = str(tmp_path / "ck")
    cfg, model, params, opt, step = _setup(steps=50)
    data = iter(SyntheticStream(cfg, batch=4, seq=32, seed=3))
    sup = TrainSupervisor(SupervisorConfig(ckpt_dir=d, ckpt_every=1000,
                                           max_steps=50,
                                           handle_sigterm=False),
                          step, data, async_ckpt=False)
    calls = {"n": 0}
    orig = sup.train_step

    def wrapped(*a):
        calls["n"] += 1
        if calls["n"] == 3:
            sup.preempted = True
        return orig(*a)

    sup.train_step = wrapped
    stop_step, *_ = sup.run(params, opt)
    assert stop_step == 3
    assert ckpt.latest_step(d) == 3      # graceful save on preemption


def test_sigterm_sets_the_preemption_flag(tmp_path):
    import signal
    cfg, model, params, opt, step = _setup(steps=2)
    old = signal.getsignal(signal.SIGTERM)
    try:
        sup = TrainSupervisor(SupervisorConfig(ckpt_dir=str(tmp_path)),
                              step, iter(()), async_ckpt=False)
        assert signal.getsignal(signal.SIGTERM) == sup._on_sigterm
        os.kill(os.getpid(), signal.SIGTERM)
        assert sup.preempted
    finally:
        signal.signal(signal.SIGTERM, old)


def test_straggler_steps_are_logged(tmp_path, monkeypatch):
    """A step 10x the EMA of its predecessors is logged; the supervisor's
    clock is replaced by one that each step advances by its own cost."""
    from repro_torch.train import fault_tolerance
    cfg, model, params, opt, step = _setup(steps=6)
    data = iter(SyntheticStream(cfg, batch=4, seq=32, seed=4))
    clock = {"now": 0.0, "n": 0}

    def timed_step(*a):
        clock["n"] += 1
        clock["now"] += 10.0 if clock["n"] == 4 else 1.0
        return step(*a)

    monkeypatch.setattr(fault_tolerance.time, "perf_counter",
                        lambda: clock["now"])
    sup = TrainSupervisor(SupervisorConfig(ckpt_dir=str(tmp_path),
                                           ckpt_every=100, max_steps=6,
                                           handle_sigterm=False),
                          timed_step, data, async_ckpt=False)
    _, _, _, log = sup.run(params, opt)
    assert sup.straggler_events == [3]
    assert [m["step_time_s"] for m in log] == [1, 1, 1, 10, 1, 1]


def test_zero1_specs():
    assert zero1_specs(P("model", None), (64, 128), 4) == P("model", "data")
    assert zero1_specs(P(None, "model"), (64, 128), 4) == P("data", "model")
    assert zero1_specs(P(None,), (7,), 4) == P(None)


def test_dedup_corpus():
    rng = np.random.default_rng(0)
    base = rng.integers(0, 100, 64)
    near_dup = base.copy()
    near_dup[:3] = rng.integers(0, 100, 3)
    distinct = rng.integers(100, 200, 64)
    docs = [base, near_dup, distinct, base.copy()]
    kept, comp = dedup_corpus(docs, s=10, k=4)
    assert comp[0] == comp[1] == comp[3]
    assert comp[2] != comp[0]
    assert len(kept) == 2


def _smoke_batch(cfg, B, S, rng):
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)),
             "labels": rng.integers(0, cfg.vocab, (B, S))}
    if cfg.family == "vlm":
        P_ = cfg.num_patches
        batch["tokens"] = batch["tokens"][:, :S - P_]
        batch["patch_embeds"] = rng.normal(
            size=(B, P_, cfg.vision_dim)).astype(np.float32)
    elif cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step(arch):
    """The reference's ``test_smoke_train_step`` on the port: every arch
    (its smoke config's microbatch and optimizer) takes one step with a
    finite loss and gradient norm, and its parameters move."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    opt_cfg = AdamConfig(lr=1e-3, use_8bit=cfg.opt_8bit, total_steps=10)
    params = model_params(model)
    opt = adam_init(params, opt_cfg)
    before = _snapshot(params)
    step = make_train_step(model, cfg, opt_cfg)
    params, opt, metrics = step(params, opt,
                                _smoke_batch(cfg, 2, 16,
                                             np.random.default_rng(1)))
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert any(not torch.equal(before[k], params[k]) for k in params)


def test_train_step_takes_only_the_models_parameters():
    cfg, model, params, opt, step = _setup()
    copies = {k: torch.nn.Parameter(p.detach().clone())
              for k, p in params.items()}
    with pytest.raises(ValueError, match="model's own parameters"):
        step(copies, opt, next(iter(SyntheticStream(cfg, 4, 8))))
    with pytest.raises(ValueError, match="microbatches"):
        step(params, opt, next(iter(SyntheticStream(cfg, 3, 8))))


def test_save_then_step_restores_the_pre_step_values(tmp_path):
    """The step updates parameters and moments in place, so a
    checkpoint copies them to the host when it is taken.  An asynchronous
    save, then a step before the writer runs, restores the values of
    before the step."""
    cfg, model, params, opt, step = _setup(steps=5)
    data = iter(SyntheticStream(cfg, batch=4, seq=32, seed=5))
    params, opt, _ = step(params, opt, next(data))
    before = _snapshot(params)
    m_before = {k: v.clone() for k, v in opt["m"].items()}
    writer = ckpt.AsyncCheckpointer(str(tmp_path / "ck"))
    try:
        writer.submit(1, ckpt.state_tree(params, opt))
        params, opt, _ = step(params, opt, next(data))
        writer.wait()
    finally:
        writer.close()
    assert any(not torch.equal(before[k], params[k]) for k in params)
    _, tree, _ = ckpt.restore(str(tmp_path / "ck"),
                              ckpt.state_like(params, opt))
    ckpt.load_state(tree, params, opt)
    for k in before:
        assert torch.equal(params[k], before[k]), k
        assert torch.equal(opt["m"][k], m_before[k]), k
    assert int(opt["count"]) == 1


def test_eval_step_is_the_loss():
    cfg, model, params, opt, step = _setup()
    batch = next(iter(SyntheticStream(cfg, batch=2, seq=8, seed=6)))
    got = make_eval_step(model)(params, batch)
    with torch.no_grad():
        want = model.loss({k: _t(v) for k, v in batch.items()})
    assert float(got) == float(want) and not got.requires_grad


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(10,), (33, 7), (4, 5, 6), (3, 300)])
def test_quantize_codes_and_scales_equal_the_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    x.flat[0] = 0.5 * np.abs(x).max()              # a half-way code
    for block in (16, 256):
        for name in ("quantize_blockwise", "quantize_shaped"):
            want_c, want_s = getattr(ref_opt, name)(jnp.asarray(x), block)
            got_c, got_s = getattr(port_opt, name)(_t(x), block)
            assert got_c.dtype == torch.int8 and got_s.dtype == torch.float32
            np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
            np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                       rtol=1e-7, atol=0)
        v = np.abs(x) ** 2
        want_c, want_s = ref_opt.quantize_v_shaped(jnp.asarray(v), block)
        got_c, got_s = port_opt.quantize_v_shaped(_t(v), block)
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                   rtol=1e-7, atol=0)
        back = port_opt.dequantize_shaped(got_c, got_s, shape, block)
        want = ref_opt.dequantize_shaped(want_c, want_s, shape, block)
        # a float32 ulp of the scale and one of the product
        np.testing.assert_allclose(back.numpy(), np.asarray(want),
                                   rtol=2.4e-7, atol=0)


def test_lr_schedule_matches_the_reference_at_every_step():
    for cfg in (AdamConfig(lr=3e-3, warmup_steps=4, total_steps=30),
                AdamConfig(lr=1e-3, warmup_steps=0, total_steps=10,
                           min_lr_ratio=0.0)):
        ref_cfg = ref_opt.AdamConfig(**dataclasses.asdict(cfg))
        for s in range(cfg.total_steps + 3):
            want = float(ref_opt.lr_schedule(ref_cfg, jnp.int32(s)))
            got = lr_schedule(cfg, torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)


def _ref_tree_to_port_state(ref_state, params):
    """The reference's optimizer state as the port's (``{name: ...}``)."""
    def moments(tree):
        flat = convert.lm_layers_from_params(tree)
        out = {}
        for k in params:
            if k in flat:
                out[k] = _t(flat[k]).clone()
            else:
                out[k] = {"codes": _t(flat[f"{k}.codes"]).clone(),
                          "scale": _t(flat[f"{k}.scale"]).clone()}
        return out
    return {"m": moments(ref_state["m"]), "v": moments(ref_state["v"]),
            "count": _t(np.asarray(ref_state["count"])).clone()}


@pytest.mark.parametrize("use_8bit", [False, True])
def test_adam_update_matches_the_reference(use_8bit):
    """One ``adam_update`` from a shared state with moments in it (one
    reference step taken first), port against reference at 1e-6: new
    parameters, float32 moments, 8-bit moments' scales; int8 codes
    equal."""
    cfg = ref_configs.get_smoke_config("recurrentgemma_2b")
    cfg = dataclasses.replace(cfg, n_layers=8)       # 2 groups + a tail of 2
    ref = ref_models.build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    opt_cfg = ref_opt.AdamConfig(lr=1e-2, use_8bit=use_8bit, q_block=16,
                                 warmup_steps=2, total_steps=10)
    rng = np.random.default_rng(0)
    grads1, grads2 = (jax.tree.map(
        lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)
                              * 0.3), params) for _ in range(2))
    state = ref_opt.adam_init(params, opt_cfg)
    params, state, _ = ref_opt.adam_update(params, grads1, state, opt_cfg)
    want_p, want_s, want_m = ref_opt.adam_update(params, grads2, state,
                                                 opt_cfg)

    port_params = {k: v.clone() for k, v in convert.lm_state_dict_from_params(
        jax.tree.map(np.asarray, params)).items()}
    port_state = _ref_tree_to_port_state(jax.tree.map(np.asarray, state),
                                         port_params)
    port_grads = convert.lm_state_dict_from_params(
        jax.tree.map(np.asarray, grads2))
    port_cfg = AdamConfig(**dataclasses.asdict(opt_cfg))
    got_p, got_s, got_m = adam_update(port_params, port_grads, port_state,
                                      port_cfg)
    assert got_p is port_params and got_s is port_state
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(got_m["lr"]), float(want_m["lr"]),
                               rtol=1e-6)
    want_flat = convert.lm_layers_from_params(jax.tree.map(np.asarray,
                                                           want_p))
    for k, p in got_p.items():
        np.testing.assert_allclose(p.numpy(), want_flat[k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert int(got_s["count"]) == int(want_s["count"]) == 2
    for mom in ("m", "v"):
        want = convert.lm_layers_from_params(
            jax.tree.map(np.asarray, want_s[mom]))
        for k in got_p:
            if use_8bit:
                np.testing.assert_array_equal(
                    got_s[mom][k]["codes"].numpy(), want[f"{k}.codes"],
                    err_msg=f"{mom} {k}")
                np.testing.assert_allclose(
                    got_s[mom][k]["scale"].numpy(), want[f"{k}.scale"],
                    rtol=1e-6, atol=0, err_msg=f"{mom} {k}")
            else:
                np.testing.assert_allclose(got_s[mom][k].numpy(), want[k],
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=f"{mom} {k}")


def test_train_step_matches_the_reference():
    """One microbatched step (2 microbatches) on the reference's weights
    and batch, float32 compute: loss and gradient norm at 1e-4, the new
    parameters at 1e-4."""
    cfg = dataclasses.replace(ref_configs.get_smoke_config("qwen3_1_7b"),
                              microbatch=2, compute_dtype="float32")
    ref = ref_models.build_model(cfg)
    params = ref.init(jax.random.PRNGKey(1))
    opt_cfg = ref_opt.AdamConfig(lr=3e-3, total_steps=10, warmup_steps=2)
    batch = next(iter(ref_train.SyntheticStream(cfg, 4, 16, seed=2)))
    want_p, _, want_m = ref_train.make_train_step(ref, cfg, opt_cfg)(
        params, ref_opt.adam_init(params, opt_cfg),
        jax.tree.map(jnp.asarray, batch))

    model = build_model(cfg, device="cpu")
    model.load_state_dict(convert.lm_state_dict_from_params(
        jax.tree.map(np.asarray, params)))
    port_cfg = AdamConfig(**dataclasses.asdict(opt_cfg))
    p = model_params(model)
    got_p, _, got_m = make_train_step(model, cfg, port_cfg)(
        p, adam_init(p, port_cfg), batch)
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]),
                               **_F32_TOL)
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), **_F32_TOL)
    want = convert.lm_layers_from_params(jax.tree.map(np.asarray, want_p))
    for k, t in got_p.items():
        np.testing.assert_allclose(t.detach().numpy(), want[k], **_F32_TOL,
                                   err_msg=k)


def test_synthetic_stream_equals_the_reference():
    for arch in ("qwen3_1_7b", "whisper_large_v3", "llava_next_mistral_7b"):
        cfg = get_smoke_config(arch)
        ours = iter(SyntheticStream(cfg, 3, 40, seed=4))
        theirs = iter(ref_train.SyntheticStream(
            ref_configs.get_smoke_config(arch), 3, 40, seed=4))
        for _ in range(2):
            a, b = next(ours), next(theirs)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_dedup_corpus_equals_the_reference():
    from repro_torch.examples.train_lm import dedup_stage
    docs, kept, comp = dedup_stage(2048)
    want_kept, want_comp = ref_train.dedup_corpus(docs, s=8, k=4)
    assert kept == want_kept and len(kept) == 40
    np.testing.assert_array_equal(comp, want_comp)
    rng = np.random.default_rng(3)
    docs = [rng.integers(0, 50, int(rng.integers(2, 40))) for _ in range(30)]
    for s in (1, 3, 6):
        got = dedup_corpus(docs, s=s, k=2)
        want = ref_train.dedup_corpus(docs, s=s, k=2)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])


def test_compressed_allreduce():
    """``tests/test_distributed.py``'s case on a logical 4-device ``data``
    axis: within the int8 bound of the plain mean, and equal (1e-6) to the
    reference's all-gather body (quantize each slice with the reference's
    ``quantize_blockwise``, dequantize, sum, divide)."""
    mesh = make_mesh((4,), ("data",), device="cpu")
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(4, 33)).astype(np.float32),
            "b": rng.normal(size=(4, 8, 9)).astype(np.float32)}
    out = compressed_allreduce({k: _t(v) for k, v in tree.items()}, mesh,
                               "data", block=16)
    for k, leaf in tree.items():
        want = np.mean(leaf, axis=0)
        got = out[k].numpy()
        assert got.shape == want.shape
        err = np.abs(got - want).max()
        assert err < np.abs(leaf).max() / 127 + 1e-6, (k, err)
        deq = []
        for i in range(4):
            c, s = ref_opt.quantize_blockwise(jnp.asarray(leaf[i]), 16)
            deq.append(np.asarray(c, np.float32) * np.asarray(s))
        body = (np.sum(deq, axis=0).reshape(-1)[:leaf[0].size] / 4).reshape(
            leaf.shape[1:])
        np.testing.assert_allclose(got, body, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="per-device slices"):
        compressed_allreduce({"a": torch.zeros(3, 2)}, mesh, "data")


@pytest.mark.parametrize("use_8bit", [False, True])
@pytest.mark.parametrize("arch", ["qwen3_1_7b", "qwen2_moe_a2_7b",
                                  "recurrentgemma_2b"])
def test_opt_state_specs_equal_the_reference(arch, use_8bit):
    cfg = ref_configs.get_smoke_config(arch)
    ref = ref_models.build_model(cfg)
    shapes = jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0)))
    port = build_model(cfg, device="meta")
    port_shapes = convert.nest_layers(
        {k: v for k, v in port.state_dict().items()},
        stack=lambda leaves: np.empty((len(leaves),) + tuple(
            leaves[0].shape), np.float32))
    for zero1 in (True, False):
        ref_cfg = ref_opt.AdamConfig(use_8bit=use_8bit, q_block=16)
        want = ref_opt.opt_state_specs(ref.param_specs(), shapes, ref_cfg,
                                       data_size=2, zero1=zero1)
        got = opt_state_specs(port.param_specs(), port_shapes,
                              AdamConfig(use_8bit=use_8bit, q_block=16),
                              data_size=2, zero1=zero1)
        assert jax.tree.map(tuple, want,
                            is_leaf=lambda x: isinstance(
                                x, jax.sharding.PartitionSpec)) == \
            jax.tree.map(tuple, got, is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("axes", [("data", "model"),
                                  ("pod", "data", "model")])
@pytest.mark.parametrize("arch", ["qwen3_1_7b", "falcon_mamba_7b",
                                  "whisper_large_v3", "llava_next_mistral_7b"])
def test_sharding_structs_equal_the_reference(arch, axes):
    """``batch_specs``, ``input_structs``, ``cache_structs`` and
    ``shard_params``: the reference's shapes, dtypes and specs on a
    mesh of the same axes (one device each)."""
    cfg = dataclasses.replace(ref_configs.get_smoke_config(arch),
                              num_patches=4)
    ref_mesh = ref_test_mesh((1,) * len(axes), axes)
    mesh = make_mesh((1,) * len(axes), axes, device="cpu")
    assert port_sharding.batch_axes(mesh) == ref_sharding.batch_axes(
        ref_mesh)

    def as_rec(s):
        return (tuple(s.shape), str(np.dtype(s.dtype)),
                tuple(s.sharding.spec))

    def port_rec(r):
        return (r.shape, str(r.dtype).split(".")[1], tuple(r.sharding.spec))

    def same(want_tree, got_tree):
        is_sds = lambda x: isinstance(x, jax.ShapeDtypeStruct)   # noqa
        want = jax.tree.map(as_rec, want_tree, is_leaf=is_sds)
        got = jax.tree.map(port_rec, got_tree, is_leaf=lambda x: isinstance(
            x, port_sharding.ShapeDtype))
        assert got == want

    assert {k: tuple(v) for k, v in port_sharding.batch_specs(
        cfg, mesh).items()} == {k: tuple(v) for k, v in
                                ref_sharding.batch_specs(cfg, ref_mesh)
                                .items()}
    same(ref_sharding.input_structs(cfg, ref_mesh, 4, 16),
         port_sharding.input_structs(cfg, mesh, 4, 16))
    ref = ref_models.build_model(cfg)
    port = build_model(cfg, device="meta")
    for long_ctx in (False, True):
        same(ref_sharding.cache_structs(ref, cfg, ref_mesh, 4, 16, long_ctx),
             port_sharding.cache_structs(port, cfg, mesh, 4, 16, long_ctx))
    same(ref_sharding.shard_params(ref, ref_mesh),
         port_sharding.shard_params(port, mesh))


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def _port_state_like_ref(cfg, params, use_8bit):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(convert.lm_state_dict_from_params(
        jax.tree.map(np.asarray, params)))
    p = model_params(model)
    return p, adam_init(p, AdamConfig(use_8bit=use_8bit, q_block=16))


@pytest.mark.parametrize("use_8bit", [False, True])
@pytest.mark.parametrize("arch,layers", [("qwen3_1_7b", 2),
                                         ("recurrentgemma_2b", 8),
                                         ("whisper_large_v3", 2)])
def test_checkpoints_cross_restore(tmp_path, arch, layers, use_8bit):
    """A checkpoint the reference writes (one step taken, so moments and
    count are set) restores into the port's live state, and the port's
    save of that state restores in the reference to the same arrays, key
    for key, file for file (``arrays.npz`` keys and bytes of every
    array equal)."""
    cfg = dataclasses.replace(ref_configs.get_smoke_config(arch),
                              n_layers=layers, compute_dtype="float32")
    ref = ref_models.build_model(cfg)
    params = ref.init(jax.random.PRNGKey(3))
    opt_cfg = ref_opt.AdamConfig(use_8bit=use_8bit, q_block=16)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    state = ref_opt.adam_init(params, opt_cfg)
    params, state, _ = ref_opt.adam_update(params, grads, state, opt_cfg)
    tree = {"params": params, "opt": state}
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_train.checkpoint.save(ref_dir, 1, tree)

    p, o = _port_state_like_ref(cfg, ref.init(jax.random.PRNGKey(4)),
                                use_8bit)
    step, back, _ = ckpt.restore(ref_dir, ckpt.state_like(p, o))
    ckpt.load_state(back, p, o)
    assert step == 1 and int(o["count"]) == 1
    want = convert.lm_layers_from_params(jax.tree.map(np.asarray, params))
    for k, t in p.items():
        np.testing.assert_array_equal(t.detach().numpy(), want[k])

    ckpt.save(port_dir, 1, ckpt.state_tree(p, o))
    like = {"params": jax.tree.map(np.asarray, params),
            "opt": jax.tree.map(np.asarray, state)}
    _, ref_back, _ = ref_train.checkpoint.restore(port_dir, like)
    jax.tree.map(np.testing.assert_array_equal, ref_back, like)
    a = np.load(os.path.join(ref_dir, "step_00000001", "arrays.npz"))
    b = np.load(os.path.join(port_dir, "step_00000001", "arrays.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------

def test_train_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    args = ["--arch", "qwen3-1.7b", "--smoke", "--steps", "4", "--batch",
            "4", "--seq", "16", "--ckpt-every", "2", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    step, params, opt, log = port_launch_train.main(args)
    assert step == 4 and [m["step"] for m in log] == [1, 2, 3, 4]
    assert all(np.isfinite(m["loss"]) for m in log)
    assert ckpt.all_steps(str(tmp_path)) == [2, 4]
    step2, *_ = port_launch_train.main(args[:3] + ["--steps", "6"] + args[5:])
    assert step2 == 6
    assert "[resume] from step 4" in capsys.readouterr().out


def test_run_training_needs_a_device_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is legal here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_launch_train.run_training(get_smoke_config("qwen3_1_7b"),
                                       steps=1, batch=2, seq=8,
                                       ckpt_dir=str(tmp_path))


def test_train_example_dedups_trains_and_resumes(tmp_path):
    from repro_torch.examples import train_lm
    got = train_lm.main(device="cpu", steps=30, ckpt_dir=str(tmp_path))
    docs, kept, comp = train_lm.dedup_stage(2048)
    assert got["kept"] == kept and len(kept) == 40
    assert got["step"] == 30 and got["checkpoints"] == [10, 20, 30]
    assert got["resumed_step"] == 30
    assert np.mean(got["losses"][-5:]) < np.mean(got["losses"][:5])
