"""Port parity for the parts of the Mamba, RG-LRU and Whisper families
below and beside the whole-model tests of ``test_torch_models.py``: the
two recurrences against the reference's functions (the chunked selective
scan, ``_rglru``), the log-step scan itself, sinusoidal positions, the
hybrid's windowed attention and its rolling-window cache past the
window, the spec trees of every arch, rematerialisation (which changes
no value) and the serving launcher on each family.  Float32 at the
reference's 1e-4 (``tests/test_models.py:162,178``) unless said."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as ref_models
import repro.models.layers as ref_layers
import repro.models.mamba as ref_mamba
import repro.models.rglru as ref_rglru
import repro.serve as ref_serve
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch import models as port_models
from repro_torch.launch import serve as port_launch_serve
from repro_torch.models import layers as port_layers
from repro_torch.models import mamba as port_mamba
from repro_torch.models import rglru as port_rglru

_F32_TOL = dict(rtol=1e-4, atol=1e-4)
_DECODE_TOL = dict(rtol=2e-2, atol=2e-2)
NEW_ARCHS = ["falcon_mamba_7b", "recurrentgemma_2b", "whisper_large_v3"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pair(arch, seed, **overrides):
    cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), **overrides)
    ref = ref_models.build_model(cfg)
    params = ref.init(jax.random.PRNGKey(seed))
    port = port_models.build_model(cfg, device="cpu")
    port.load_state_dict(convert.lm_state_dict_from_params(
        jax.tree.map(np.asarray, params)))
    return ref, params, port, cfg


def _specs_as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _specs_as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_specs_as_tuples(v) for v in tree]
    return tuple(tree)


# ---------------------------------------------------------------------------
# positions and recurrences
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [64, 1280])
def test_sinusoidal_positions_match_the_reference(d):
    pos = np.concatenate([np.arange(1500), [2047, 4095]]).astype(np.int32)
    want = np.asarray(ref_layers.sinusoidal_positions(jnp.asarray(pos), d))
    got = port_layers.sinusoidal_positions(_t(pos), d)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **_F32_TOL)


@pytest.mark.parametrize("n", [1, 2, 7, 64, 257])
def test_linear_scan_equals_the_sequential_recurrence(n):
    """h_t = a_t h_{t-1} + b_t from 0, and the running products of a, in
    float64 (exact up to rounding order)."""
    g = torch.Generator().manual_seed(n)
    a = torch.rand((3, n, 5), generator=g, dtype=torch.float64)
    b = torch.randn((3, n, 5), generator=g, dtype=torch.float64)
    acc, h = port_layers.linear_scan(a, b, dim=1)
    want_h, want_acc = [], []
    cur, prod = torch.zeros(3, 5, dtype=torch.float64), torch.ones(
        3, 5, dtype=torch.float64)
    for t in range(n):
        cur = a[:, t] * cur + b[:, t]
        prod = prod * a[:, t]
        want_h.append(cur)
        want_acc.append(prod)
    torch.testing.assert_close(h, torch.stack(want_h, 1), rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(acc, torch.stack(want_acc, 1), rtol=1e-12,
                               atol=1e-12)


def _scan_inputs(rng, b, s, di, st):
    u = rng.normal(size=(b, s, di)).astype(np.float32)
    # softplus of wide inputs: dt from ~0 to ~5, so exp(dt·A) spans
    # 1 to exp(-80) with A down to -16
    dt = np.log1p(np.exp(3 * rng.normal(size=(b, s, di)))).astype(
        np.float32)
    A = -np.tile(np.arange(1, st + 1, dtype=np.float32), (di, 1))
    Bc = rng.normal(size=(b, s, st)).astype(np.float32)
    Cc = rng.normal(size=(b, s, st)).astype(np.float32)
    return u, dt, A, Bc, Cc


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s,chunk", [(16, 8), (13, 8), (1, 8), (24, 8),
                                     (300, 256), (256, 256)])
def test_selective_scan_matches_the_reference(s, chunk, with_h0):
    """``_selective_scan_chunked`` on lengths that are and are not a
    multiple of the chunk (the tail padded with identity steps), with and
    without a carried state; A down to -16, as ``A_log``'s init."""
    rng = np.random.default_rng(s * 7 + chunk + with_h0)
    b, di, st = 2, 6, 16
    u, dt, A, Bc, Cc = _scan_inputs(rng, b, s, di, st)
    h0 = rng.normal(size=(b, di, st)).astype(np.float32) if with_h0 \
        else None
    want_y, want_h = ref_mamba._selective_scan_chunked(
        jnp.asarray(u), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(Bc),
        jnp.asarray(Cc), chunk, None if h0 is None else jnp.asarray(h0))
    got_y, got_h = port_mamba._selective_scan_chunked(
        _t(u), _t(dt), _t(A), _t(Bc), _t(Cc), chunk,
        None if h0 is None else _t(h0))
    assert tuple(got_y.shape) == (b, s, di) and got_y.dtype == torch.float32
    assert tuple(got_h.shape) == (b, di, st)
    assert torch.isfinite(got_y).all() and torch.isfinite(got_h).all()
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **_F32_TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **_F32_TOL)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [1, 5, 16, 33])
def test_rglru_matches_the_reference(s, with_h0):
    """``_rglru``: the whole-sequence scan, with the initial state added
    after it, as the reference's."""
    cfg = dataclasses.replace(ref_configs.get_smoke_config(
        "recurrentgemma_2b"), compute_dtype="float32")
    p = ref_rglru._init_rec(jax.random.PRNGKey(s), cfg)
    rng = np.random.default_rng(s + 100 * with_h0)
    xs = rng.normal(size=(2, s, cfg.drnn)).astype(np.float32)
    h0 = rng.normal(size=(2, cfg.drnn)).astype(np.float32) if with_h0 \
        else None
    want_y, want_h = ref_rglru._rglru(p, jnp.asarray(xs),
                                      None if h0 is None else jnp.asarray(h0))
    rec = port_rglru.RecBlock(cfg)
    rec.load_state_dict(convert.lm_state_dict_from_params(
        jax.tree.map(np.asarray, p)))
    with torch.no_grad():
        got_y, got_h = port_rglru._rglru(rec, _t(xs),
                                         None if h0 is None else _t(h0))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **_F32_TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **_F32_TOL)


# ---------------------------------------------------------------------------
# the hybrid's local attention
# ---------------------------------------------------------------------------

def test_windowed_chunked_attention():
    """The reference's ``test_windowed_chunked_attention`` on the port's
    ``GriffinLM`` (chunk 4, window 6, float32: chunked against dense),
    and the chunked logits against the reference's."""
    over = dict(attn_chunk=4, window=6, compute_dtype="float32")
    ref, params, port, cfg = _pair("recurrentgemma_2b", 4, **over)
    port0 = port_models.build_model(dataclasses.replace(cfg, attn_chunk=0),
                                    device="cpu")
    port0.load_state_dict(port.state_dict())
    x = np.random.default_rng(4).integers(0, cfg.vocab, (2, 16))
    with torch.no_grad():
        dense, _ = port0.apply(_t(x))
        chunked, _ = port.apply(_t(x))
    np.testing.assert_allclose(dense.numpy(), chunked.numpy(), **_F32_TOL)
    want, _ = ref.apply(params, jnp.asarray(x))
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want), **_F32_TOL)


def _every_block_attention(q, k, v, n_rep, causal, window, chunk):
    """The online-softmax loop over every (q, kv) block pair, masked
    blocks included: the plain version of ``layers._sdpa_chunked``."""
    b, sq, h, hd = q.shape
    kv, n = k.shape[2], sq // chunk
    qs = q.reshape(b, n, chunk, kv, n_rep, hd).permute(1, 0, 3, 4, 2, 5)
    ks = k.reshape(b, n, chunk, kv, hd).permute(1, 0, 3, 2, 4)
    vs = v.reshape(b, n, chunk, kv, hd).permute(1, 0, 3, 2, 4)
    outs = []
    for qi in range(n):
        m = torch.full((b, kv, n_rep, chunk), -float("inf"))
        l = torch.zeros((b, kv, n_rep, chunk))
        acc = torch.zeros((b, kv, n_rep, chunk, hd))
        qpos = qi * chunk + torch.arange(chunk)[:, None]
        for ki in range(n):
            s_ = torch.einsum("bkrqh,bksh->bkrqs", qs[qi].float(),
                              ks[ki].float()) * (1.0 / np.sqrt(hd))
            kpos = ki * chunk + torch.arange(chunk)[None, :]
            ok = torch.ones((chunk, chunk), dtype=torch.bool)
            if causal:
                ok &= kpos <= qpos
            if window:
                ok &= kpos > qpos - window
            s_ = torch.where(ok, s_, -float("inf"))
            m_new = torch.maximum(m, s_.amax(dim=-1))
            m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            p_ = torch.exp(s_ - m_safe[..., None])
            corr = torch.exp(m - m_safe)
            l = l * corr + p_.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkrqs,bksh->bkrqh", p_.to(vs.dtype).float(),
                vs[ki].float())
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    out = torch.stack(outs)
    return out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq, h, hd)


@pytest.mark.parametrize("per_step", [1, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 6),
                                           (True, 16), (False, 0)])
def test_chunked_attention_equals_the_every_block_loop(
        dtype, causal, window, per_step, monkeypatch):
    """``_sdpa_chunked`` takes ``per_step`` q chunks a product (3 leaves a
    shorter last group) and leaves out the kv blocks none of them sees;
    its output is the every-block loop's up to the rounding of the
    batched float32 product (a few float32 ulps; the bf16 outputs agree
    exactly here)."""
    monkeypatch.setattr(port_layers, "Q_CHUNKS_PER_STEP", per_step)
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 32, h, 8, generator=g).to(dtype)
               for h in (4, 2, 2))
    got = port_layers._sdpa_chunked(q, k, v, 2, causal=causal,
                                    window=window, chunk_q=4, chunk_k=4)
    want = _every_block_attention(q, k, v, 2, causal, window, 4)
    if dtype == torch.bfloat16:
        assert torch.equal(got, want)
        return
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    grads = []
    for fn in (lambda *t: port_layers._sdpa_chunked(
            *t, 2, causal=causal, window=window, chunk_q=4, chunk_k=4),
               lambda *t: _every_block_attention(*t, 2, causal, window, 4)):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves)
        (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)
         ).sum().backward()
        grads.append([x.grad for x in leaves])
    for got_g, want_g in zip(*grads):
        torch.testing.assert_close(got_g, want_g, rtol=1e-5, atol=1e-5)


def test_attention_chunks_benchmark_on_the_host(tmp_path):
    """``benchmarks/attention_chunks`` on the host at smoke widths: the
    host clock, no peak, and its sampled output is the every-block
    loop's on the same seeded inputs; ``--against`` its own file gives
    a difference of 0."""
    from repro_torch.benchmarks import attention_chunks
    out = tmp_path / "a.json"
    rec = attention_chunks.main(["--smoke", "--seq", "64", "--chunk", "16",
                                 "--device", "cpu", "--out", str(out)])
    assert rec["device"] == "cpu" and rec["peak_bytes_above_inputs"] is None
    assert rec["q_chunks_per_step"] == port_layers.Q_CHUNKS_PER_STEP
    assert len(rec["times_s"]) == 3 and rec["time_s"] > 0
    cfg = port_configs.get_smoke_config("qwen3-1.7b")
    q, k, v = attention_chunks._inputs(cfg, 64, torch.device("cpu"), False)
    want = _every_block_attention(q, k, v, 2, True, 0, 16)
    assert rec["sample"] == attention_chunks.sample_of(want)
    last = torch.zeros(2 ** 25 + 3)
    last[-1] = 7.0                      # past float32's exact integers
    assert attention_chunks.sample_of(last)[-1] == 7.0
    again = attention_chunks.main(["--smoke", "--seq", "64", "--chunk",
                                   "16", "--device", "cpu", "--backward",
                                   "--against", str(out)])
    assert again["backward"] and again["max_abs_diff"] == 0.0


@pytest.mark.parametrize("seq", [32, 128])
def test_chunked_attention_score_block_does_not_grow_with_length(
        seq, monkeypatch):
    """The largest product ``_sdpa_chunked`` makes is a score block of
    ``Q_CHUNKS_PER_STEP`` q chunks by one kv chunk, at any length."""
    sizes = []
    einsum = port_layers._f32_einsum

    def spy(spec, *ops):
        out = einsum(spec, *ops)
        if spec.endswith("qs"):                  # the score products
            sizes.append(out.numel())
        return out

    monkeypatch.setattr(port_layers, "_f32_einsum", spy)
    q, k, v = (torch.randn(2, seq, h, 8) for h in (4, 2, 2))
    port_layers._sdpa_chunked(q, k, v, 2, causal=True, window=0,
                              chunk_q=4, chunk_k=4)
    assert max(sizes) <= 2 * 2 * 2 * port_layers.Q_CHUNKS_PER_STEP * 4 * 4


def test_rolling_window_cache_wraps_past_the_window():
    """The smoke config's window of 8 and 12 decode steps: the cache holds
    min(window, max_seq) = 8 slots, position p lands in slot p % 8, and
    from p = 8 on every slot is live.  Logits against the reference at
    1e-4 (float32) at every step, against the windowed forward at
    ``_DECODE_TOL``, and the wrapped K/V equal the reference's."""
    ref, params, port, cfg = _pair("recurrentgemma_2b", 6,
                                   compute_dtype="float32")
    assert cfg.window == 8
    S = 12
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (2, S))
    rc = ref.init_cache(2, S, dtype=jnp.float32)
    pc = port.init_cache(2, S, dtype=torch.float32)
    assert pc["k"].shape[2] == 8 == rc["k"].shape[2]
    with torch.no_grad():
        full, _ = port.apply(_t(tokens))
    for t in range(S):
        want, rc = ref.decode_step(params, rc, jnp.asarray(tokens[:, t:t + 1]),
                                   jnp.int32(t))
        with torch.no_grad():
            got, pc = port.decode_step(pc, _t(tokens[:, t:t + 1]), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **_F32_TOL)
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, t].numpy(),
                                   **_DECODE_TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(pc[k].numpy(), np.asarray(rc[k]),
                                   **_F32_TOL)
    # slot 3 now holds position 11 (it held position 3 before the wrap)
    with torch.no_grad():
        fresh = port.init_cache(2, S, dtype=torch.float32)
        for t in range(4):
            port.decode_step(fresh, _t(tokens[:, t:t + 1]), t)
    assert not torch.allclose(fresh["k"][:, :, 3], pc["k"][:, :, 3])


# ---------------------------------------------------------------------------
# Whisper's cross cache
# ---------------------------------------------------------------------------

def test_prefill_cross_fills_only_the_cross_cache():
    ref, params, port, cfg = _pair("whisper_large_v3", 8,
                                   compute_dtype="float32")
    frames = np.random.default_rng(8).normal(
        size=(2, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    rc = ref.prefill_cross(params, ref.init_cache(2, 5, dtype=jnp.float32),
                           jnp.asarray(frames))
    pc = port.init_cache(2, 5, dtype=torch.float32)
    kept = _t(frames).clone()
    frames_t = _t(frames)
    out = port.prefill_cross(pc, frames_t)
    assert out is pc and torch.equal(frames_t, kept)
    assert not pc["k"].any() and not pc["v"].any()
    for k in ("cross_k", "cross_v"):
        np.testing.assert_allclose(pc[k].numpy(), np.asarray(rc[k]),
                                   **_F32_TOL)


# ---------------------------------------------------------------------------
# specs, remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_param_and_cache_specs_equal_the_reference(arch):
    """``param_specs`` (layers stacked) and ``cache_specs`` (both
    contexts), entry for entry, as plain tuples."""
    cfg = ref_configs.get_smoke_config(arch)
    ref = ref_models.build_model(cfg)
    port = port_models.build_model(cfg, device="meta")
    assert _specs_as_tuples(port.param_specs()) == \
        _specs_as_tuples(ref.param_specs())
    for long_ctx in (False, True):
        assert _specs_as_tuples(port.cache_specs(long_ctx)) == \
            _specs_as_tuples(ref.cache_specs(long_ctx))


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_state_dict_converts_back_to_the_reference_tree(arch):
    """``convert.lm_params_from_state_dict`` inverts
    ``lm_state_dict_from_params``: the reference's own tree (stacked
    layers, the hybrid's ``tail`` list, empty or not), value for value,
    which the reference's ``apply`` takes."""
    over = dict(n_layers=8) if arch == "recurrentgemma_2b" else {}
    for extra in ({}, over):
        ref, params, port, cfg = _pair(arch, 10, compute_dtype="float32",
                                       **extra)
        tree = convert.lm_params_from_state_dict(port.state_dict(),
                                                 specs=port.param_specs())
        want = jax.tree.map(np.asarray, params)
        assert jax.tree.structure(tree) == jax.tree.structure(want)
        jax.tree.map(np.testing.assert_array_equal, tree, want)
    tokens = jnp.asarray(np.random.default_rng(10).integers(
        0, cfg.vocab, (1, 4)))
    if cfg.family == "encdec":
        frames = jnp.zeros((1, cfg.enc_frames, cfg.d_model), jnp.float32)
        args = (tokens, frames)
    else:
        args = (tokens,)
    np.testing.assert_array_equal(np.asarray(ref.apply(tree, *args)[0]),
                                  np.asarray(ref.apply(params, *args)[0]))


def test_layer_specs_equal_the_reference():
    for arch in ("qwen2_7b", "qwen3_1_7b", "qwen2_moe_a2_7b", "arctic_480b"):
        cfg = ref_configs.get_smoke_config(arch)
        assert _specs_as_tuples(port_layers.attention_specs(cfg)) == \
            _specs_as_tuples(ref_layers.attention_specs(cfg))
        if cfg.n_experts:
            for sharding in ("model", "model+data", "ffn"):
                c = dataclasses.replace(cfg, expert_sharding=sharding)
                assert _specs_as_tuples(port_layers.moe_specs(c)) == \
                    _specs_as_tuples(ref_layers.moe_specs(c))
    for kind in ("swiglu", "gelu"):
        assert _specs_as_tuples(port_layers.mlp_specs(kind)) == \
            _specs_as_tuples(ref_layers.mlp_specs(kind))
    assert tuple(port_layers.rms_specs()["scale"]) == (None,)
    assert repr(port_layers.P("model", None)) == "P('model', None)"


def _loss_and_grads(model, batch):
    model.zero_grad(set_to_none=True)
    loss = model.loss(batch)
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone()
                         for k, p in model.named_parameters()}


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["qwen3_1_7b", "falcon_mamba_7b",
                                  "recurrentgemma_2b", "whisper_large_v3"])
def test_remat_changes_no_value(arch, policy):
    """Checkpointed blocks (``cfg.remat``, either policy) give the loss
    and every gradient of the plain run, bit for bit."""
    base = dataclasses.replace(port_configs.get_smoke_config(arch),
                               remat=False, compute_dtype="float32")
    plain = port_models.build_model(base, device="cpu").init(
        torch.Generator().manual_seed(3))
    remat = port_models.build_model(
        dataclasses.replace(base, remat=True, remat_policy=policy),
        device="cpu")
    remat.load_state_dict(plain.state_dict())
    rng = np.random.default_rng(3)
    batch = {"tokens": _t(rng.integers(0, base.vocab, (2, 10))),
             "labels": _t(rng.integers(0, base.vocab, (2, 10)))}
    if base.family == "encdec":
        batch["frames"] = _t(rng.normal(size=(2, base.enc_frames,
                                              base.d_model)).astype(
            np.float32))
    loss0, g0 = _loss_and_grads(plain, batch)
    loss1, g1 = _loss_and_grads(remat, batch)
    assert loss0 == loss1
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_remat_policy_saves_only_batch_free_matmuls():
    dots = dataclasses.replace(port_configs.get_smoke_config("qwen3_1_7b"),
                               remat_policy="dots")
    policy = port_layers.remat_policy(dots)
    keep = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    assert policy(None, torch.ops.aten.mm.default) == keep
    assert policy(None, torch.ops.aten.bmm.default) != keep
    assert port_layers.remat_policy(
        dataclasses.replace(dots, remat_policy="full")) is None


# ---------------------------------------------------------------------------
# the serving launcher on each family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_launcher_tokens_equal_the_reference(arch):
    """``launch.serve.serve`` (bf16 cache, float32 compute here): the
    prompts and, for Whisper, the frames drawn from one numpy stream as
    the reference's launcher draws them, the cross K/V prefilled, then
    the reference's drivers' greedy tokens."""
    ref, params, port, cfg = _pair(arch, 9, compute_dtype="float32")
    B, P, G = 2, 5, 6
    res = port_launch_serve.serve(port, batch=B, prompt_len=P, gen=G,
                                  seed=9)
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, cfg.vocab, (B, P))
    cache = ref.init_cache(B, P + G)
    if cfg.family == "encdec":
        frames = rng.normal(size=(B, cfg.enc_frames, cfg.d_model)).astype(
            np.float32)
        np.testing.assert_array_equal(res["frames"].numpy(), frames)
        cache = ref.prefill_cross(params, cache, jnp.asarray(frames))
    else:
        assert res["frames"] is None
    np.testing.assert_array_equal(res["prompts"], prompts)
    last, cache = ref_serve.prefill_with_decode(
        ref, params, cache, jnp.asarray(prompts, jnp.int32))
    want, _ = ref_serve.greedy_decode(ref, params, cache, last, P, G)
    np.testing.assert_array_equal(res["tokens"], np.asarray(want))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_launcher_main_runs_each_family_on_the_cpu(arch, capsys):
    res = port_launch_serve.main(["--arch", arch.replace("_", "-"),
                                  "--smoke", "--device", "cpu", "--batch",
                                  "2", "--prompt-len", "3", "--gen", "4"])
    cfg = port_configs.get_smoke_config(arch)
    assert res["tokens"].shape == (2, 4)
    assert 0 <= res["tokens"].min() and res["tokens"].max() < cfg.vocab
    assert f"arch={cfg.name}" in capsys.readouterr().out
