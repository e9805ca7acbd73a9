"""Epidemic case study (paper Exp-5 / Fig. 4) on the port (the
reference's ``examples/epidemic_case_study.py``): co-location hypergraph,
risk quantification by max-reachability, told through the workload
subsystem (``repro_torch.workloads``): contact-tracing chains come from
witness extraction, spread horizons from hop-bounded s-reach and the
landmark s-distance oracle, superspreaders from top-k ranking, and
cohort risk from set-to-set MR.  Every headline number is asserted
against the brute-force references, so the story doubles as a check.
The engine's batches (the risk vector, ``top_s``, ``mr_set``) join
through the ``label_join_gather`` kernel on the card.

  PYTHONPATH=src python -m repro_torch.examples.epidemic_case_study
  PYTHONPATH=src python -m repro_torch.examples.epidemic_case_study \\
      --device cpu

``main`` returns the answers it printed (the tests hold them to the
reference's).
"""
import argparse

import numpy as np

from repro_torch.api import build_engine, colocation_hypergraph, verify_witness
from repro_torch.core import (MSTOracle, brute_force_mr_set,
                              brute_force_s_distance, brute_force_s_reach_k,
                              brute_force_top_s)


def main(device: str = "cuda", n_people: int = 400) -> dict:
    out = {}
    # 21-day window, one hyperedge per (place, day): people checked in
    h = colocation_hypergraph(n_people=n_people, n_places=12, n_days=21,
                              p_checkin=0.03, seed=3)
    print(f"co-location hypergraph: {h.n} people, {h.m} (place, day) groups")
    eng = build_engine(h, "hl-index", device=device, use_kernels=True)
    oracle = MSTOracle(h)        # brute-force cross-check for point MR

    patient_zero = int(np.argmax(h.vertex_degrees))
    everyone = np.arange(h.n)
    risk = np.asarray(eng.mr_batch(np.full(h.n, patient_zero), everyone))
    out["patient_zero"] = patient_zero
    print(f"\nindex case: person {patient_zero} "
          f"({h.degree(patient_zero)} check-ins)")

    # -- contact tracing: witness walks name the actual venues ------------
    # MR says *how strong* a transmission chain is; the witness walk says
    # *which (place, day) groups* realize it — the actionable artifact.
    order = np.argsort(-risk)
    order = order[order != patient_zero]
    # top contacts share a venue directly; a mid-risk contact shows a
    # genuine multi-gathering chain
    mid = int(order[np.searchsorted(-risk[order], -3)])
    print("\ncontact-tracing chains (top-risk and one mid-risk contact):")
    out["witnesses"] = []
    for p in [*order[:3], mid]:
        w = eng.mr_witness(patient_zero, int(p))
        assert verify_witness(h, w)            # walk is a valid s-walk
        assert w.s == oracle.mr(patient_zero, int(p))
        out["witnesses"].append((int(p), int(w.s), tuple(w.walk)))
        hops = " -> ".join(f"group {e}" for e in w.walk)
        print(f"  person {int(p):4d}  MR = {w.s}  via {hops}")

    # -- spread horizon: how fast can infection arrive? -------------------
    # s_reach_k bounds the walk length: "reachable within k gatherings".
    s = 2
    top = int(order[0])
    horizon = next(k for k in range(1, h.m + 1)
                   if eng.s_reach_k(patient_zero, top, s, k))
    assert brute_force_s_reach_k(h, patient_zero, top, s, horizon)
    assert not brute_force_s_reach_k(h, patient_zero, top, s, horizon - 1)
    out["horizon"] = (top, horizon)
    print(f"\nspread horizon (s = {s}): person {top} is reachable in "
          f"{horizon} gathering(s), not fewer")

    # the landmark oracle serves certified upper bounds on that horizon
    # for the whole population at once — bound >= exact, zero iff zero
    do = eng.distance_oracle(s)
    sample = [int(p) for p in order[:5]]
    print(f"landmark s-distance bounds ({do.num_landmarks} landmarks):")
    out["s_distance"] = []
    for p in sample:
        bound = eng.s_distance(patient_zero, p, s)
        exact = brute_force_s_distance(h, patient_zero, p, s)
        assert (bound == 0) == (exact == 0) and bound >= exact
        out["s_distance"].append((p, int(bound), int(exact)))
        print(f"  person {p:4d}  <= {bound} gatherings (exact {exact})")

    # -- superspreaders: top-k strongest-s ranking ------------------------
    print("\ntop-5 superspreader contacts of the index case:")
    verts, vals = eng.top_s(patient_zero, 5)
    bv, bs = brute_force_top_s(h, patient_zero, 5)
    assert np.array_equal(verts, bv) and np.array_equal(vals, bs)
    out["top5"] = (verts.tolist(), vals.tolist())
    for p, v in zip(verts.tolist(), vals.tolist()):
        print(f"  person {p:4d}  MR = {v}")

    # -- cohort risk: set-to-set MR ---------------------------------------
    # "does the infected household threaten the care-home cohort?" is one
    # mr_set call — a batched label join, not |U| x |V| point queries
    household = [patient_zero] + [int(p) for p in order[:2]]
    cohort = [int(p) for p in order[-20:]]
    link = eng.mr_set(np.asarray(household), np.asarray(cohort))
    assert link == brute_force_mr_set(h, household, cohort)
    out["cohort_link"] = int(link)
    print(f"\nhousehold {household} -> {len(cohort)}-person cohort: "
          f"strongest cross link MR = {link}")

    hist = {int(t): int((risk[everyone != patient_zero] == t).sum())
            for t in np.unique(risk)}
    out["histogram"] = hist
    print("risk histogram {MR: count}:", hist)
    print("\nall workload answers verified against brute force")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
