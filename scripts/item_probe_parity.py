#!/usr/bin/env python3
"""The item index's navigation graph and search, as
``scripts/item_index_probe.py`` wrote them from the card, held against
both packages on the CPU.

Reads the probe's ``.npz`` (the posting-list centroids, the graph built
on the card, the list members, the 512 queries), then:

* rebuilds the incremental graph from the same centroids with the port's
  and the JAX package's ``build_navgraph`` (per-vertex host loops) and
  compares their neighbours and entry with the card's;
* runs both packages' ``search`` over the card's graph for every query
  and compares the lists;
* counts the queries whose ``top_m`` lists hold fewer than ``k`` rows,
  through the search and through the exact nearest centroids.

Like the tests, it imports both packages and runs on the CPU only.

    PYTHONPATH=src python scripts/item_probe_parity.py \
        chiprun_out/item_probe.npz [--no-rebuild]
"""

import argparse
import json
import sys
import time

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("npz")
    ap.add_argument("--no-rebuild", action="store_true",
                    help="skip the two incremental builds (minutes each)")
    args = ap.parse_args()
    from repro.core import navgraph as rnav
    from repro_torch.core import navgraph as ng
    z = np.load(args.npz)
    top_m, k = int(z["top_m"]), int(z["k"])
    offsets, flat = z["offsets"], z["members"]     # each read decompresses
    members = [flat[offsets[i]:offsets[i + 1]]
               for i in range(len(offsets) - 1)]
    pts, queries = z["points"], z["queries"]
    parts = dict(points=pts, neighbors=z["neighbors"],
                 entry=int(z["entry"]),
                 super_centroids=z["super_centroids"],
                 super_assign=z["super_assign"])
    card_graph = ng.NavGraph(**parts)
    ref_graph = rnav.NavGraph(**parts)
    out = {"centroids": len(pts), "queries": len(queries)}

    def rows(cids) -> int:
        return len(np.unique(np.concatenate([members[c] for c in cids])))

    port_found = [ng.search(card_graph, q, top_m) for q in queries]
    ref_found = [rnav.search(ref_graph, q, top_m) for q in queries]
    card_found = [f[f >= 0] for f in z["found"]]
    out["search_port_eq_ref"] = all(np.array_equal(a, b) for a, b in
                                    zip(port_found, ref_found))
    out["search_port_eq_card"] = all(np.array_equal(a, b) for a, b in
                                     zip(port_found, card_found))
    short = [i for i, f in enumerate(ref_found) if rows(f) < k]
    q64, p64 = queries.astype(np.float64), pts.astype(np.float64)
    d2 = ((q64 ** 2).sum(1)[:, None] - 2.0 * q64 @ p64.T
          + (p64 ** 2).sum(1)[None])
    exact = np.argsort(d2, axis=1, kind="stable")[:, :top_m]
    out["short_ref_search"] = short
    out["short_exact_lists"] = [i for i, c in enumerate(exact)
                                if rows(c) < k]
    served = z["served_ids"]
    out["short_served"] = [int(i) for i in
                           np.nonzero((served < 0).any(1))[0]]
    out["served_short_has_every_candidate"] = all(
        int((served[i] >= 0).sum()) == rows(ref_found[i])
        for i in out["short_served"])
    if not args.no_rebuild:
        degree = int(z["degree"])
        for name, build in (
                ("port", lambda: ng.build_navgraph(
                    pts, degree=degree, device=torch.device("cpu"))),
                ("ref", lambda: rnav.build_navgraph(pts, degree=degree))):
            t = time.perf_counter()
            g = build()
            out[f"rebuild_{name}_s"] = round(time.perf_counter() - t, 1)
            out[f"rebuild_{name}_neighbors_eq_card"] = bool(
                np.array_equal(g.neighbors, z["neighbors"]))
            out[f"rebuild_{name}_entry_eq_card"] = g.entry == int(z["entry"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
