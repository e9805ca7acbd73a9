"""Port parity, the LM serving path: ``repro_torch.models`` /
``repro_torch.configs`` / ``repro_torch.serve`` (``kvcache``,
``serve_step``) on the CPU against ``repro``'s on the smoke configs of the
seven transformer-family archs (``dense``, ``moe``, ``vlm``).  Both
packages run the reference's own weights (``model.init(PRNGKey)``,
carried across with ``convert.lm_state_dict_from_params``: the two PRNGs
draw different numbers from one seed).  Floats are compared at the
reference's own tolerances (``tests/test_models.py``): forward and
chunked attention at 1e-4 in float32, decode against forward at
``_DECODE_TOL``; in the configs' bf16, port against reference at
``_BF16_TOL``; config fields, shapes and parameter counts are equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as ref_models
import repro.models.layers as ref_layers
import repro.serve as ref_serve
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch import models as port_models
from repro_torch.models import layers as port_layers
from repro_torch.serve import (greedy_decode, make_prefill_step,
                               make_serve_step, prefill_with_decode)

TRANSFORMER_ARCHS = [a for a in ref_configs.ARCH_IDS
                     if ref_configs.get_config(a).family
                     in ("dense", "moe", "vlm")]
NOT_PORTED = {"falcon_mamba_7b": "ssm", "recurrentgemma_2b": "hybrid",
              "whisper_large_v3": "encdec"}
ROUTER_FREE_ARCHS = [a for a in TRANSFORMER_ARCHS
                     if ref_configs.get_config(a).family != "moe"]
_F32_TOL = dict(rtol=1e-4, atol=1e-4)       # tests/test_models.py:162,178
_DECODE_TOL = dict(rtol=2e-2, atol=2e-2)    # tests/test_models.py:73
# port against reference with both in bf16: set from the readings of
# test_forward_and_served_decode_match_the_reference_in_bf16 (largest
# 2.14 x _DECODE_TOL; the packages round bf16 apart by one or two ulps)
_BF16_TOL = dict(rtol=5e-2, atol=5e-2)


def _batch(cfg, B, S, rng):
    """The reference test's ``_batch`` as numpy arrays."""
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)),
             "labels": rng.integers(0, cfg.vocab, (B, S))}
    if cfg.family == "vlm":
        P = cfg.num_patches
        batch["tokens"] = batch["tokens"][:, :S - P]
        batch["patch_embeds"] = rng.normal(
            size=(B, P, cfg.vision_dim)).astype(np.float32)
    return batch


def _pair(arch, seed, **overrides):
    """(reference model, its params, port model on the CPU with the same
    weights, the shared config)."""
    cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), **overrides)
    ref = ref_models.build_model(cfg)
    params = ref.init(jax.random.PRNGKey(seed))
    port_cfg = dataclasses.replace(port_configs.get_smoke_config(arch),
                                   **overrides)
    port = port_models.build_model(port_cfg, device="cpu")
    port.load_state_dict(convert.lm_state_dict_from_params(
        jax.tree.map(np.asarray, params)))
    return ref, params, port, cfg


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_forward_and_loss_match_the_reference_in_float32(arch):
    ref, params, port, cfg = _pair(arch, 0, compute_dtype="float32")
    batch = _batch(cfg, 2, 16, np.random.default_rng(0))
    pe = batch.get("patch_embeds")
    want, want_aux = ref.apply(params, jnp.asarray(batch["tokens"]),
                               None if pe is None else jnp.asarray(pe))
    with torch.no_grad():
        got, got_aux = port.apply(_t(batch["tokens"]),
                                  None if pe is None else _t(pe))
        got_loss = port.loss({k: _t(v) for k, v in batch.items()})
    assert tuple(got.shape) == (2, 16, cfg.vocab) == want.shape
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_F32_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **_F32_TOL)
    want_loss = ref.loss(params, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    np.testing.assert_allclose(float(got_loss), float(want_loss),
                               **_F32_TOL)


@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_smoke_forward_and_loss_in_the_config_dtype(arch):
    """The reference's ``test_smoke_forward_and_loss`` on the port (bf16
    compute, as the smoke configs say): shapes, dtypes, finite values."""
    ref, params, port, cfg = _pair(arch, 0)
    batch = _batch(cfg, 2, 16, np.random.default_rng(0))
    pe = batch.get("patch_embeds")
    with torch.no_grad():
        logits, aux = port.apply(_t(batch["tokens"]),
                                 None if pe is None else _t(pe))
        loss = port.loss({k: _t(v) for k, v in batch.items()})
    assert tuple(logits.shape) == (2, 16, cfg.vocab)
    assert logits.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert torch.isfinite(logits.float()).all()
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_decode_matches_forward(arch):
    """Teacher-forced decode against the full forward, as the reference's
    ``test_decode_matches_forward`` (config dtype, float32 cache)."""
    _, _, port, cfg = _pair(arch, 0)
    tokens = _t(np.random.default_rng(2).integers(0, cfg.vocab, (2, 12)))
    with torch.no_grad():
        full, _ = port.apply(tokens)
        cache = port.init_cache(2, 12, dtype=torch.float32)
        outs = []
        for t in range(12):
            lg, cache = port.decode_step(cache, tokens[:, t:t + 1], t)
            outs.append(lg[:, 0].float())
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                               full.float().numpy(), **_DECODE_TOL)


@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_decode_logits_match_the_reference(arch):
    """One decode step after a teacher-forced prefix, port against
    reference, float32 compute and cache."""
    ref, params, port, cfg = _pair(arch, 1, compute_dtype="float32")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (2, 6))
    rc = ref.init_cache(2, 6, dtype=jnp.float32)
    pc = port.init_cache(2, 6, dtype=torch.float32)
    for t in range(6):
        want, rc = ref.decode_step(params, rc, jnp.asarray(tokens[:, t:t + 1]),
                                   jnp.int32(t))
        with torch.no_grad():
            got, pc = port.decode_step(pc, _t(tokens[:, t:t + 1]), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **_F32_TOL)
    np.testing.assert_allclose(pc["k"].numpy(), np.asarray(rc["k"]),
                               **_F32_TOL)
    np.testing.assert_allclose(pc["v"].numpy(), np.asarray(rc["v"]),
                               **_F32_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("arch", ROUTER_FREE_ARCHS)
def test_forward_and_served_decode_match_the_reference_in_bf16(arch, seed):
    """The configs' bf16 compute with the served bf16 cache (``init_cache``
    default): forward logits, decode logits along the same tokens and the
    K/V caches, port against reference, at ``_BF16_TOL``.  The MoE archs
    are held in bf16 at the layer (``test_moe_apply_matches_the_reference
    _in_bf16``): in a whole model the packages' one-ulp differences flip
    near-tied router choices, and a flipped expert moves a logit by far
    more than a rounding."""
    ref, params, port, cfg = _pair(arch, seed)
    assert cfg.compute_dtype == "bfloat16"
    tokens = np.random.default_rng(5 + seed).integers(0, cfg.vocab, (2, 12))
    want, _ = ref.apply(params, jnp.asarray(tokens))
    with torch.no_grad():
        got, _ = port.apply(_t(tokens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_BF16_TOL)
    rc, pc = ref.init_cache(2, 12), port.init_cache(2, 12)
    assert pc["k"].dtype == torch.bfloat16
    for t in range(12):
        want, rc = ref.decode_step(params, rc, jnp.asarray(tokens[:, t:t + 1]),
                                   jnp.int32(t))
        with torch.no_grad():
            got, pc = port.decode_step(pc, _t(tokens[:, t:t + 1]), t)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **_BF16_TOL)
    for k in ("k", "v"):
        assert pc[k].dtype == torch.bfloat16
        np.testing.assert_allclose(pc[k].float().numpy(),
                                   np.asarray(rc[k], np.float32), **_BF16_TOL)


@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_greedy_tokens_equal_the_reference(arch):
    """``prefill_with_decode`` + ``greedy_decode`` give the reference's
    tokens, and the logits along its token stream agree at 1e-4."""
    ref, params, port, cfg = _pair(arch, 2, compute_dtype="float32")
    B, P, G = 3, 7, 9
    prompts = np.random.default_rng(11).integers(0, cfg.vocab, (B, P))
    rc = ref.init_cache(B, P + G, dtype=jnp.float32)
    last, rc = ref_serve.prefill_with_decode(ref, params, rc,
                                             jnp.asarray(prompts, jnp.int32))
    want, _ = ref_serve.greedy_decode(ref, params, rc, last, P, G)
    want = np.asarray(want)
    prompt_t = _t(prompts.astype(np.int32))
    kept = prompt_t.clone()
    pc = port.init_cache(B, P + G, dtype=torch.float32)
    plast, pc = prefill_with_decode(port, pc, prompt_t)
    got, _ = greedy_decode(port, pc, plast, P, G)
    assert torch.equal(prompt_t, kept)         # the prompt is only read
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, G)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(plast.numpy(), np.asarray(last), **_F32_TOL)
    stream = np.concatenate([prompts, want], axis=1)
    ref_logits, _ = ref.apply(params, jnp.asarray(stream))
    with torch.no_grad():
        port_logits, _ = port.apply(_t(stream))
    np.testing.assert_allclose(port_logits.numpy(), np.asarray(ref_logits),
                               **_F32_TOL)


def test_chunked_attention_matches_dense_and_the_reference():
    """The reference's ``test_chunked_attention_matches_dense`` on the
    port, and the chunked logits against the reference's chunked ones."""
    over = dict(attn_chunk=4, compute_dtype="float32")
    ref, params, port, cfg = _pair("qwen3_1_7b", 3, **over)
    port0 = port_models.build_model(
        dataclasses.replace(port.cfg, attn_chunk=0), device="cpu")
    port0.load_state_dict(port.state_dict())
    x = np.random.default_rng(3).integers(0, cfg.vocab, (2, 16))
    with torch.no_grad():
        dense, _ = port0.apply(_t(x))
        chunked, _ = port.apply(_t(x))
    np.testing.assert_allclose(dense.numpy(), chunked.numpy(), **_F32_TOL)
    want, _ = ref.apply(params, jnp.asarray(x))
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want), **_F32_TOL)


@pytest.mark.parametrize("window", [6, 3])
def test_windowed_chunked_attention_matches_the_reference(window):
    """``attention_apply(window=)`` (``TransformerLM`` takes no window; the
    reference's windowed test runs RG-LRU): chunked against dense on the
    port, and against the reference's function, float32, 1e-4."""
    base = ref_configs.get_smoke_config("qwen3_1_7b")
    cfg = dataclasses.replace(base, attn_chunk=4, compute_dtype="float32")
    cfg0 = dataclasses.replace(cfg, attn_chunk=0)
    p = ref_layers.init_attention(jax.random.PRNGKey(4), cfg)
    x = np.random.default_rng(4).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32)
    want = ref_layers.attention_apply(p, cfg, jnp.asarray(x), window=window)
    att = port_layers.Attention(cfg)
    att.load_state_dict(convert.lm_state_dict_from_params(
        jax.tree.map(np.asarray, p)))
    with torch.no_grad():
        chunked = port_layers.attention_apply(att, cfg, _t(x), window=window)
        dense = port_layers.attention_apply(att, cfg0, _t(x), window=window)
    np.testing.assert_allclose(chunked.numpy(), dense.numpy(), **_F32_TOL)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want), **_F32_TOL)


@pytest.mark.parametrize("capacity", [False, True])
def test_moe_apply_matches_the_reference(capacity):
    """Both dispatch routes of ``moe_apply`` (dense and capacity), output
    and aux loss, float32."""
    cfg = dataclasses.replace(ref_configs.get_smoke_config("qwen2_moe_a2_7b"),
                              moe_capacity=capacity, compute_dtype="float32",
                              capacity_factor=0.75)
    p = ref_layers.init_moe(jax.random.PRNGKey(6), cfg)
    x = np.random.default_rng(6).normal(
        size=(2, 8, cfg.d_model)).astype(np.float32)
    want, want_aux = ref_layers.moe_apply(p, cfg, jnp.asarray(x))
    moe = port_layers.MoE(cfg)
    moe.load_state_dict(convert.lm_state_dict_from_params(
        jax.tree.map(np.asarray, p)))
    with torch.no_grad():
        got, got_aux = port_layers.moe_apply(moe, cfg, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_F32_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **_F32_TOL)


@pytest.mark.parametrize("capacity", [False, True])
def test_moe_apply_matches_the_reference_in_bf16(capacity):
    """Both routes of ``moe_apply`` in the config's bf16 on one bf16 input:
    the router runs in float32 from the same values in both packages, so
    the routing agrees and the output is held at ``_DECODE_TOL``."""
    cfg = dataclasses.replace(ref_configs.get_smoke_config("qwen2_moe_a2_7b"),
                              moe_capacity=capacity, capacity_factor=0.75)
    assert cfg.compute_dtype == "bfloat16"
    p = ref_layers.init_moe(jax.random.PRNGKey(6), cfg)
    x = jnp.asarray(np.random.default_rng(6).normal(
        size=(2, 8, cfg.d_model)), jnp.bfloat16)
    want, want_aux = ref_layers.moe_apply(p, cfg, x)
    moe = port_layers.MoE(cfg)
    moe.load_state_dict(convert.lm_state_dict_from_params(
        jax.tree.map(np.asarray, p)))
    with torch.no_grad():
        got, got_aux = port_layers.moe_apply(
            moe, cfg, _t(np.asarray(x, np.float32)).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_DECODE_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **_F32_TOL)


@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_parameters_map_one_to_one(arch):
    """Every reference leaf lands on one port parameter of its shape, and
    the counts agree with each other and with ``ArchConfig.n_params``'s
    family formula inputs (shapes, not values)."""
    ref, params, port, cfg = _pair(arch, 0)
    sd = convert.lm_state_dict_from_params(jax.tree.map(np.asarray, params))
    assert sorted(sd) == sorted(port.state_dict())
    for k, v in port.state_dict().items():
        assert tuple(v.shape) == tuple(sd[k].shape), k
    ref_count = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in port.parameters()) == ref_count


def test_serve_and_prefill_steps_match_the_model():
    ref, params, port, cfg = _pair("qwen3_1_7b", 7, compute_dtype="float32")
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (2, 5))
    prefill = make_prefill_step(port, port.cfg)
    want = ref_serve.make_prefill_step(ref, cfg)(
        params, {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(prefill({"tokens": _t(tokens)}).numpy(),
                               np.asarray(want), **_F32_TOL)
    step = make_serve_step(port, port.cfg)
    cache = port.init_cache(2, 5, dtype=torch.float32)
    lg, cache2 = step(cache, _t(tokens[:, :1]), 0)
    assert cache2 is cache and tuple(lg.shape) == (2, 1, cfg.vocab)


def test_configs_equal_the_reference_field_for_field():
    assert port_configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert port_configs.ALIASES == ref_configs.ALIASES
    for arch in ref_configs.ARCH_IDS:
        for get in ("get_config", "get_smoke_config"):
            want = getattr(ref_configs, get)(arch)
            got = getattr(port_configs, get)(arch)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert (got.hd, got.dtr, got.d_inner, got.drnn) == \
                (want.hd, want.dtr, want.d_inner, want.drnn)
            assert got.n_params() == want.n_params()
            assert got.n_active_params() == want.n_active_params()
    for alias, name in ref_configs.ALIASES.items():
        assert port_configs.get_config(alias) == port_configs.get_config(name)
    assert list(port_configs.all_configs()) == ref_configs.ARCH_IDS


def test_full_configs_match_assignment():
    """The reference's ``test_full_configs_match_assignment`` on the
    port's configs."""
    spec = {
        "llava_next_mistral_7b": (32, 4096, 32, 8, 14336, 32000),
        "falcon_mamba_7b": (64, 4096, 1, 1, 0, 65024),
        "qwen2_5_14b": (48, 5120, 40, 8, 13824, 152064),
        "qwen2_7b": (28, 3584, 28, 4, 18944, 152064),
        "qwen3_1_7b": (28, 2048, 16, 8, 6144, 151936),
        "minitron_8b": (32, 4096, 32, 8, 16384, 256000),
        "whisper_large_v3": (32, 1280, 20, 20, 5120, 51866),
        "qwen2_moe_a2_7b": (24, 2048, 16, 16, 1408, 151936),
        "arctic_480b": (35, 7168, 56, 8, 4864, 32000),
        "recurrentgemma_2b": (26, 2560, 10, 1, 7680, 256000),
    }
    get = port_configs.get_config
    for arch, (L, d, h, kv, f, v) in spec.items():
        cfg = get(arch)
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                cfg.d_ff, cfg.vocab) == (L, d, h, kv, f, v), arch
    assert get("falcon_mamba_7b").ssm_state == 16
    assert get("qwen2_moe_a2_7b").n_experts == 60
    assert get("qwen2_moe_a2_7b").top_k == 4
    assert get("qwen2_moe_a2_7b").n_shared_experts == 4
    assert get("arctic_480b").n_experts == 128
    assert get("arctic_480b").top_k == 2
    assert get("arctic_480b").dense_residual
    assert get("qwen3_1_7b").qk_norm
    assert get("qwen2_7b").qkv_bias and get("qwen2_5_14b").qkv_bias
    assert get("recurrentgemma_2b").window == 2048
    assert get("arctic_480b").n_params() > 400e9
    assert get("arctic_480b").n_active_params() < 30e9


@pytest.mark.parametrize("arch", sorted(NOT_PORTED))
def test_build_model_raises_for_the_families_not_ported(arch):
    cfg = port_configs.get_smoke_config(arch)
    assert cfg.family == NOT_PORTED[arch]
    with pytest.raises(NotImplementedError, match="A12b-2"):
        port_models.build_model(cfg, device="cpu")


def test_build_model_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is legal here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_models.build_model(port_configs.get_smoke_config("qwen3_1_7b"))


def test_init_draws_the_reference_distributions():
    """``init(generator)``: seeded and repeatable; norms ones, biases
    zeros, embeddings at std 0.02, projections at std 1/sqrt(d_in)."""
    cfg = port_configs.get_smoke_config("qwen2_7b")        # qkv bias
    a = port_models.build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    b = port_models.build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    assert torch.equal(a.ln_f.scale, torch.ones(cfg.d_model))
    assert torch.equal(a.blocks[0].attn.wq.b, torch.zeros(
        cfg.n_heads * cfg.hd))
    assert abs(float(a.embed.detach().std()) - 0.02) < 0.002
    w = a.blocks[1].mlp.down.w.detach()
    assert abs(float(w.std()) * np.sqrt(cfg.d_ff) - 1.0) < 0.05
