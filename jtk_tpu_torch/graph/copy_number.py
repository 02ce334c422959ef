"""Copy-number assignment on the ditch graph — min-cost-flow optimizer.

Reference: ``haplotyper/src/copy_number_estimation/copy_number_flow.rs`` (the
production algorithm, COPYNUM_ALGORITHM=4 in update_copy_numbers.rs:38) and
the simple-path reduction feeding it (update_copy_numbers.rs:252-409).

The model: integer copy numbers minimizing
    sum_nodes len * (cov - cp*hap_cov)^2 + sum_edges (cov - cp*hap_cov)^2
optimized over *coordinated* +-1 moves along source-sink paths and cycles of a
residual graph, so flow conservation emerges by construction.  Each simple
path of the assembly graph becomes a 4-vertex gadget (copy_number_flow.rs:
6-15): vertices 4i/4i+3 face other paths ("external"), 4i+1/4i+2 are internal;
the two inner arcs (4i->4i+1, 4i+3->4i+2) carry the node copy number, and
connecting edges attach at the gadget side of their terminal.  Walking a
forward arc increments the underlying copy number, a residual back arc
decrements it (floor 0).

Host-side numpy by design (graphs are ~10^3 elements, SURVEY.md §2.5), but
vectorized where it counts: Bellman-Ford relaxes all residual arcs per round
as array ops with early stopping, negative cycles are detected with one
all-zeros-source sweep instead of the reference's per-(source,sink) scans,
and a discovered improving path is re-applied while it keeps improving —
same move class and objective, far fewer Python-level iterations.
"""

from __future__ import annotations

import logging
from collections import defaultdict

import numpy as np

from .ditch_graph import HEAD, TAIL, DitchGraph

logger = logging.getLogger(__name__)

LARGE = 1e17
MIN_IMPROVE = 1e-11


class FlowGraph:
    """Residual-graph copy-number optimizer over simple-path nodes.

    nodes: [(target_cov, length)] per simple path.
    edges: [(from, fdir, to, tdir, target_cov)] connecting edges; fdir/tdir
    are the terminal flags (False = first discovered terminal of the path,
    True = second), as produced by :func:`reduce_simple_path`.
    """

    def __init__(self, nodes, edges, hap_cov: float):
        self.node_target = np.array([n[0] for n in nodes], float)
        self.node_len = np.array([n[1] for n in nodes], float)
        self.edge_target = np.array([e[4] for e in edges], float)
        self.hap_cov = float(max(hap_cov, 1e-6))
        self.node_cp = np.zeros(len(nodes), np.int64)
        self.edge_cp = np.zeros(len(edges), np.int64)
        self.V = 4 * len(nodes)

        frm, to, ttype, tidx = [], [], [], []

        def push(u, v, typ, idx):
            # forward arc + residual back arc
            frm.extend([u, v]); to.extend([v, u])
            ttype.extend([typ, typ]); tidx.extend([idx, idx])

        for i in range(len(nodes)):
            push(4 * i, 4 * i + 1, 0, i)
            push(4 * i + 3, 4 * i + 2, 0, i)
        for j, (f, fdir, t, tdir, _cov) in enumerate(edges):
            fsource, fdest = (4 * f + 2, 4 * f) if fdir else \
                (4 * f + 1, 4 * f + 3)
            tsource, tdest = (4 * t + 2, 4 * t) if tdir else \
                (4 * t + 1, 4 * t + 3)
            push(fsource, tdest, 1, j)
            if fsource != tsource or fdest != tdest:
                push(tsource, fdest, 1, j)
        self.res_from = np.array(frm, np.int64)
        self.res_to = np.array(to, np.int64)
        self.tgt_type = np.array(ttype, np.int8)   # 0 = node, 1 = edge
        self.tgt_idx = np.array(tidx, np.int64)
        # direction rule (copy_number_flow.rs:110-123): a vertex is external
        # iff idx % 4 in {0, 3}; node arcs go external->internal forward,
        # edge arcs internal->external forward
        from_ext = np.isin(self.res_from % 4, (0, 3))
        self.is_back = np.where(self.tgt_type == 0, ~from_ext, from_ext)
        self.out_deg = np.bincount(self.res_from, minlength=self.V) \
            if self.V else np.zeros(0, np.int64)

    # ---------------- scoring ----------------

    def _arc_scores(self) -> np.ndarray:
        """Marginal penalty of walking each residual arc once (+-1 on its
        underlying copy number); LARGE for decrements at 0."""
        hc = self.hap_cov
        d = np.where(self.is_back, -1, 1)
        is_node = self.tgt_type == 0
        ni = np.clip(self.tgt_idx, 0, max(len(self.node_cp) - 1, 0))
        ei = np.clip(self.tgt_idx, 0, max(len(self.edge_cp) - 1, 0))
        cp = np.where(is_node, self.node_cp[ni],
                      self.edge_cp[ei] if len(self.edge_cp) else 0)
        tgt = np.where(is_node, self.node_target[ni],
                       self.edge_target[ei] if len(self.edge_cp) else 0.0)
        w = np.where(is_node, self.node_len[ni], 1.0)
        new = (tgt - (cp + d) * hc) ** 2
        old = (tgt - cp * hc) ** 2
        sc = (new - old) * w
        return np.where(self.is_back & (cp == 0), LARGE, sc)

    def penalty(self) -> float:
        hc = self.hap_cov
        n = float(np.sum(self.node_len
                         * (self.node_target - self.node_cp * hc) ** 2))
        e = float(np.sum((self.edge_target - self.edge_cp * hc) ** 2))
        return n + e

    # ---------------- residual-graph search ----------------

    def _bellman_ford(self, scores, dists):
        """Vectorized Bellman-Ford from given initial dists.  Returns
        (dists, pred_arc, saturated) where saturated=True means round V still
        relaxed (a negative cycle is reachable)."""
        pred = np.full(self.V, -1, np.int64)
        ok = scores < LARGE
        frm, to = self.res_from[ok], self.res_to[ok]
        sc = scores[ok]
        arc_ids = np.flatnonzero(ok)
        saturated = False
        for rnd in range(self.V):
            src_d = dists[frm]
            cand = np.where(src_d < LARGE, src_d + sc, LARGE)
            best = dists.copy()
            np.minimum.at(best, to, cand)
            improved_v = best + MIN_IMPROVE < dists
            if not improved_v.any():
                break
            hit = np.flatnonzero(improved_v[to] & (cand <= best[to]))
            pred[to[hit]] = arc_ids[hit]
            dists = best
        else:
            saturated = True
        return dists, pred, saturated

    def _trace_path(self, pred, source, sink):
        path = []
        cur = sink
        for _ in range(self.V + 1):
            if cur == source:
                return path[::-1]
            a = pred[cur]
            if a < 0:
                return None
            path.append(a)
            cur = self.res_from[a]
        return None

    def _find_negative_cycle(self, scores):
        """All-zeros-source sweep: any remaining relaxation after V rounds
        lies on / leads into a negative-score cycle; walk predecessors V
        times to land inside it."""
        dists = np.zeros(self.V)
        dists, pred, saturated = self._bellman_ford(scores, dists)
        if not saturated:
            return None
        ok = (scores < LARGE) & (dists[self.res_from] < LARGE)
        viol = np.flatnonzero(
            ok & (dists[self.res_from] + scores + MIN_IMPROVE
                  < dists[self.res_to]))
        for a in viol:
            cur = int(self.res_from[a])
            for _ in range(self.V + 3):
                if pred[cur] < 0:
                    cur = -1
                    break
                cur = int(self.res_from[pred[cur]])
            if cur < 0:
                continue
            root, cycle = cur, []
            a2 = pred[cur]
            for _ in range(self.V + 1):
                cycle.append(int(a2))
                cur = int(self.res_from[a2])
                if cur == root:
                    return cycle[::-1]
                a2 = pred[cur]
                if a2 < 0:
                    break
        return None

    def _bfs_path(self, scores, source, sink):
        """Hop-layered BFS path (copy_number_flow.rs:432-494): used when
        Bellman-Ford distances are poisoned by a (true-eval nonnegative)
        negative-score cycle."""
        dists = np.full(self.V, LARGE)
        pred = np.full(self.V, -1, np.int64)
        seen = np.zeros(self.V, bool)
        dists[source] = 0.0
        seen[source] = True
        frontier = [source]
        ok = scores < LARGE
        while frontier and not seen[sink]:
            mask = ok & np.isin(self.res_from, frontier) \
                & ~seen[self.res_to]
            arcs = np.flatnonzero(mask)
            if len(arcs) == 0:
                break
            # first writer per destination wins (any is fine)
            dest = self.res_to[arcs]
            uniq, first = np.unique(dest, return_index=True)
            a_sel = arcs[first]
            dists[uniq] = dists[self.res_from[a_sel]] + scores[a_sel]
            pred[uniq] = a_sel
            seen[uniq] = True
            frontier = uniq.tolist()
        if dists[sink] >= 0:
            return None
        return self._trace_path(pred, source, sink)

    def _sources(self):
        """Residual vertices whose only arc is their inner arc — path ends
        facing nothing (copy_number_flow.rs:600-611); if none exist (pure
        cycles), two representatives per connected component."""
        ss = np.flatnonzero(self.out_deg == 1)
        if len(ss):
            return ss.tolist(), ss.tolist()
        comp = self._components()
        reps = defaultdict(list)
        for v, c in enumerate(comp):
            if len(reps[c]) < 2:
                reps[c].append(v)
        pairs = [r for r in reps.values() if len(r) == 2]
        return [p[0] for p in pairs], [p[1] for p in pairs]

    def _components(self):
        from .find_union import FindUnion
        fu = FindUnion(self.V)
        for u, v in zip(self.res_from, self.res_to):
            fu.unite(int(u), int(v))
        return [fu.find(v) for v in range(self.V)]

    # ---------------- moves ----------------

    def _eval(self, path):
        """True penalty delta of applying every arc in ``path`` (+-1 each
        traversal, aggregated per target); None if any copy would go
        negative (copy_number_flow.rs:543-586)."""
        nd = defaultdict(int)
        ed = defaultdict(int)
        for a in path:
            d = -1 if self.is_back[a] else 1
            if self.tgt_type[a] == 0:
                nd[int(self.tgt_idx[a])] += d
            else:
                ed[int(self.tgt_idx[a])] += d
        hc = self.hap_cov
        score = 0.0
        for i, d in nd.items():
            if d == 0:
                continue
            cp = int(self.node_cp[i])
            if cp + d < 0:
                return None
            t, ln = self.node_target[i], self.node_len[i]
            score += ((t - (cp + d) * hc) ** 2 - (t - cp * hc) ** 2) * ln
        for j, d in ed.items():
            if d == 0:
                continue
            cp = int(self.edge_cp[j])
            if cp + d < 0:
                return None
            t = self.edge_target[j]
            score += (t - (cp + d) * hc) ** 2 - (t - cp * hc) ** 2
        return score

    def _apply(self, path):
        for a in path:
            d = -1 if self.is_back[a] else 1
            if self.tgt_type[a] == 0:
                self.node_cp[self.tgt_idx[a]] += d
            else:
                self.edge_cp[self.tgt_idx[a]] += d

    def _update(self) -> bool:
        """One improving move: a negative cycle if one has negative true
        eval, else the best negative source-sink path; the chosen move is
        re-applied while it keeps strictly improving."""
        scores = self._arc_scores()
        cycle = self._find_negative_cycle(scores)
        if cycle is not None:
            ev = self._eval(cycle)
            if ev is not None and ev < 0:
                self._apply(cycle)
                while True:
                    ev = self._eval(cycle)
                    if ev is None or ev >= 0:
                        break
                    self._apply(cycle)
                return True
        sources, sinks = self._sources()
        best, best_path = 0.0, None
        sink_set = set(sinks) | set(sources)
        for s in set(sources):
            dists = np.full(self.V, LARGE)
            dists[s] = 0.0
            dists, pred, saturated = self._bellman_ford(scores, dists)
            for t in sink_set:
                if t == s or dists[t] >= 0:
                    continue
                path = None if saturated else self._trace_path(pred, s, t)
                if path is None:
                    path = self._bfs_path(scores, s, t)
                if path is None:
                    continue
                ev = self._eval(path)
                if ev is not None and ev < best:
                    best, best_path = ev, path
        if best_path is None:
            return False
        self._apply(best_path)
        while True:
            ev = self._eval(best_path)
            if ev is None or ev >= 0:
                break
            self._apply(best_path)
        return True

    def optimize(self, max_iter: int = 100000):
        self.node_cp[:] = 0
        self.edge_cp[:] = 0
        logger.debug("COPY\tFLOW\tPenalty\t0\t%.1f", self.penalty())
        for _ in range(max_iter):
            if not self._update():
                break
        logger.debug("COPY\tFLOW\tPenalty\t1\t%.1f", self.penalty())

    def copy_numbers(self):
        return self.node_cp.copy(), self.edge_cp.copy()


# ---------------- ditch-graph plumbing ----------------

def reduce_simple_path(g: DitchGraph):
    """Contract maximal simple paths (update_copy_numbers.rs:289-320).

    Returns (node_to_pathid, path_nodes [(mean_occ, n_members)],
    conv_edges [(fp_path, fdir, tp_path, tdir, occ)], edge_terminal: edge
    key -> index into conv_edges, in_path_keys: set of edge keys inside a
    path)."""
    from .find_union import FindUnion
    nodes = sorted(g.nodes.keys())
    nidx = {n: i for i, n in enumerate(nodes)}
    deg = {}
    for n in nodes:
        for p in (HEAD, TAIL):
            deg[(n, p)] = sum(1 for k in g._adj[(n, p)] if k in g.edges)
    in_path, between = [], []
    for key, e in g.edges.items():
        if deg[(e.from_node, e.from_plug)] == 1 \
                and deg[(e.to_node, e.to_plug)] == 1:
            in_path.append(key)
        else:
            between.append(key)
    fu = FindUnion(len(nodes))
    for key in in_path:
        e = g.edges[key]
        fu.unite(nidx[e.from_node], nidx[e.to_node])
    roots = {}
    node_to_pathid = {}
    for n in nodes:
        r = fu.find(nidx[n])
        if r not in roots:
            roots[r] = len(roots)
        node_to_pathid[n] = roots[r]
    P = len(roots)
    occ_sum = np.zeros(P)
    members = np.zeros(P, np.int64)
    for n in nodes:
        pid = node_to_pathid[n]
        occ_sum[pid] += g.nodes[n].occ
        members[pid] += 1
    path_nodes = [(occ_sum[p] / max(members[p], 1), int(members[p]))
                  for p in range(P)]
    terminals = [[] for _ in range(P)]

    def terminal_flag(pid, node, plug):
        t = (node, plug)
        if t in terminals[pid]:
            return terminals[pid].index(t) == 1
        terminals[pid].append(t)
        # >2 distinct plugs on one contracted path should be impossible;
        # clamp to the second slot rather than crash on pathological input
        if len(terminals[pid]) > 2:
            logger.warning("path %d has >2 terminals: %s", pid,
                           terminals[pid])
            return True
        return len(terminals[pid]) == 2

    conv_edges = []
    edge_terminal = {}
    for key in between:
        e = g.edges[key]
        fp = node_to_pathid[e.from_node]
        tp = node_to_pathid[e.to_node]
        fdir = terminal_flag(fp, e.from_node, e.from_plug)
        tdir = terminal_flag(tp, e.to_node, e.to_plug)
        edge_terminal[key] = len(conv_edges)
        conv_edges.append((fp, fdir, tp, tdir, float(e.occ)))
    return node_to_pathid, path_nodes, conv_edges, edge_terminal, set(in_path)


def assign_copy_numbers(g: DitchGraph, hap_cov: float,
                        method: str = "flow") -> None:
    """Assign node/edge copy numbers on the simple-path-reduced graph.

    ``method`` selects the solver like the reference's COPYNUM_ALGORITHM
    (update_copy_numbers.rs:37-46): "flow" (production), "gibbs", "mcmc"
    (MRF), or "mst"."""
    if not g.nodes:
        return
    node_to_pathid, path_nodes, conv_edges, edge_terminal, in_path = \
        reduce_simple_path(g)
    if method == "flow":
        fg = FlowGraph(path_nodes, conv_edges, hap_cov)
        fg.optimize()
        node_cp, edge_cp = fg.copy_numbers()
    elif method == "gibbs":
        from .copy_number_alt import estimate_copy_number_gbs
        node_cp, edge_cp = estimate_copy_number_gbs(
            [w for w, _l in path_nodes], conv_edges, hap_cov)
    elif method == "mcmc":
        from .copy_number_alt import estimate_copy_number_mcmc
        node_cp, edge_cp = estimate_copy_number_mcmc(
            path_nodes, conv_edges, hap_cov)
    elif method == "mst":
        from .copy_number_alt import estimate_copy_number_mst
        node_cp, edge_cp = estimate_copy_number_mst(
            path_nodes, conv_edges, hap_cov)
    else:
        raise ValueError(f"unknown copy-number method {method!r}")
    for n, dn in g.nodes.items():
        dn.copy_num = int(node_cp[node_to_pathid[n]])
    for key, e in g.edges.items():
        if key in in_path:
            e.copy_num = int(node_cp[node_to_pathid[e.from_node]])
        else:
            e.copy_num = int(edge_cp[edge_terminal[key]])
