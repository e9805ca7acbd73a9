"""The port's examples (``repro_torch.examples``) on the CPU at small
sizes: each ``main(device="cpu")`` runs to its end (keeping its own
assertions) and returns the answers it printed, which equal what the
reference's example computes on the same inputs through ``repro.api``
(Figure 1's MR(v5, v9) = 2 among them), or, for the LM serving example,
through the reference's model and decode drivers on the same weights."""
import numpy as np
import pytest

import repro.api as R

from repro_torch.examples import (distributed_reachability,
                                  epidemic_case_study, quickstart,
                                  serve_lm, serving_quickstart)


def test_quickstart_answers_equal_the_reference():
    got = quickstart.main(device="cpu", n=300, m=450, chains=4,
                          chain_len=10)
    fig = R.build_engine(R.paper_figure1(), backend="hl-index")
    assert got["figure1"] == (fig.mr(4, 8), fig.mr(0, 11),
                              fig.s_reach(0, 9, 2)) == (2, 2, True)
    h, _ = R.compact(R.random_hypergraph(300, 450, min_size=2, max_size=8,
                                         seed=0))
    eng = R.build_engine(h, backend="hl-index")
    assert got["planned"] == R.plan_backend(h, batch_hint=10_000)
    rng = np.random.default_rng(0)
    us, vs = rng.integers(0, h.n, 10000), rng.integers(0, h.n, 10000)
    assert got["first20"] == [eng.mr(int(u), int(v))
                              for u, v in zip(us[:20], vs[:20])]
    ans = np.asarray(eng.snapshot().mr(us, vs)).astype(np.int64)
    assert (got["batch_max"], got["batch_sum"]) == (int(ans.max()),
                                                   int(ans.sum()))
    assert got["backends"] == R.available_backends()
    assert got["version"] == (0, 1)


def test_serving_quickstart_answers_equal_the_reference():
    got = serving_quickstart.main(device="cpu", requests=300)
    h = R.random_hypergraph(2000, 512, seed=0)
    eng = R.build_engine(h, "hl-index")
    assert (got["mr_4_8"], got["sreach_4_8_2"]) == (eng.mr(4, 8),
                                                    eng.s_reach(4, 8, 2))
    rng = np.random.default_rng(0)
    want = [eng.mr(int(u), int(v)) if rng.random() < 0.5
            else eng.s_reach(int(u), int(v), int(rng.integers(1, 5)))
            for u, v in zip(rng.integers(0, h.n, 300),
                            rng.integers(0, h.n, 300))]
    assert (got["burst_max"], got["burst_sum"]) == (
        max(want), sum(int(a) for a in want))

    hc = R.planted_chain_hypergraph(16, 20, overlap=3, extra_size=2, seed=0)
    svc = R.serve(hc, backend="hl-index", start=False)
    svc.mr(0, 1)
    svc.drain()
    anchor = [int(v) for v in hc.edge(0)[:2]]
    svc.update(inserts=[anchor + [hc.n]])
    f = svc.mr(anchor[0], hc.n)
    svc.drain()
    assert got["after_update"] == f.result(timeout=0) == 3
    assert got["refresh_rows"] == (svc.engine.last_snapshot_refresh_rows,
                                   svc.engine.h.n) == (44, 689)
    svc.close()
    # the reference example prints these for the same traffic
    assert got["shares"] == {"analytics": 16, "dashboard": 48}
    assert got["deadline"] is True
    assert got["replica_batches"] == [1, 0]


def test_epidemic_case_study_answers_equal_the_reference():
    got = epidemic_case_study.main(device="cpu", n_people=150)
    h = R.colocation_hypergraph(n_people=150, n_places=12, n_days=21,
                                p_checkin=0.03, seed=3)
    eng = R.build_engine(h, "hl-index")
    pz = int(np.argmax(h.vertex_degrees))
    assert got["patient_zero"] == pz
    everyone = np.arange(h.n)
    risk = np.asarray(eng.mr_batch(np.full(h.n, pz), everyone))
    for p, s, walk in got["witnesses"]:
        w = eng.mr_witness(pz, p)
        assert (s, walk) == (w.s, tuple(w.walk))
    top, horizon = got["horizon"]
    assert eng.s_reach_k(pz, top, 2, horizon)
    assert horizon == 1 or not eng.s_reach_k(pz, top, 2, horizon - 1)
    for p, bound, exact in got["s_distance"]:
        assert bound == eng.s_distance(pz, p, 2)
    verts, vals = eng.top_s(pz, 5)
    assert got["top5"] == (np.asarray(verts).tolist(),
                           np.asarray(vals).tolist())
    order = np.argsort(-risk)
    order = order[order != pz]
    household = [pz] + [int(p) for p in order[:2]]
    cohort = [int(p) for p in order[-20:]]
    assert got["cohort_link"] == int(eng.mr_set(np.asarray(household),
                                                 np.asarray(cohort)))
    assert got["histogram"] == {
        int(t): int((risk[everyone != pz] == t).sum())
        for t in np.unique(risk)}


def test_distributed_reachability_answers_equal_the_reference():
    got = distributed_reachability.main(device="cpu", n=60, m=90)
    # the reference example prints correct=True for each and "sharded"
    assert got["closure_correct"] == {"allgather": True, "ring": True}
    assert got["threshold_correct"] is True
    assert got["engine_correct"] == {"allgather": True, "ring": True}
    assert got["planned"] == "sharded"
    # no byte count: on the host the wrapper runs its plain version
    assert got["round_launches"] == {"allgather": 0, "ring": 0}


def test_serve_lm_tokens_equal_the_reference():
    """The LM serving example on the reference's own weights (carried
    across with ``convert``) and float32 compute: the same left-padded
    prompts, and the greedy tokens of the reference example's steps."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.models import build_model
    from repro.serve import greedy_decode, prefill_with_decode
    from repro_torch import convert

    cfg = dataclasses.replace(get_smoke_config("qwen3_1_7b"),
                              compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    got = serve_lm.main(device="cpu", requests=4, max_prompt=12, gen=8,
                        state_dict=convert.lm_state_dict_from_params(
                            jax.tree.map(np.asarray, params)),
                        compute_dtype="float32")
    rng = np.random.default_rng(0)
    lens = rng.integers(4, 13, 4)
    pad = int(lens.max())
    prompts = np.zeros((4, pad), np.int32)
    for i, ln in enumerate(lens):
        prompts[i, pad - ln:] = rng.integers(1, cfg.vocab, ln)
    np.testing.assert_array_equal(got["prompts"], prompts)
    cache = model.init_cache(4, pad + 8)
    last, cache = prefill_with_decode(model, params, cache,
                                      jnp.asarray(prompts))
    toks, _ = greedy_decode(model, params, cache, last, pad, 8)
    np.testing.assert_array_equal(got["tokens"], np.asarray(toks))
    # its own seeded weights, in the config's bf16
    own = serve_lm.main(device="cpu", requests=3, max_prompt=8, gen=4)
    assert own["tokens"].shape == (3, 4) and own["tokens"].dtype == np.int32
    assert ((own["tokens"] >= 0) & (own["tokens"] < cfg.vocab)).all()


@pytest.mark.parametrize("module", [quickstart, serving_quickstart,
                                    epidemic_case_study,
                                    distributed_reachability, serve_lm])
def test_examples_default_to_the_card(module):
    import inspect
    import torch
    assert inspect.signature(module.main).parameters["device"].default \
        == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            module.main()
