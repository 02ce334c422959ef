"""DitchGraph — bidirected assembly graph over (chunk, cluster) nodes.

Reference: ``haplotyper/src/assemble/ditch_graph/mod.rs`` (SURVEY.md §2.3):
node = (chunk, cluster) with Head/Tail plugs, edge label = representative gap
sequence or overlap offset; constructed from encoded reads; cleaned by
lightweight-edge removal, tip removal, copy-number assignment and
zero-copy-element removal; ``spell`` traverses simple paths into contigs.

Host-side Python by design: graphs are ~10^3 nodes (SURVEY.md §2.5), all the
FLOPs live in the kernels, and correctness of the heuristics matters more than
device execution here.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

from .. import seq as seqmod

logger = logging.getLogger(__name__)

HEAD, TAIL = 0, 1  # plug positions


def _rc(label: str) -> str:
    return seqmod.revcomp_ascii(label.encode()).decode()


@dataclass
class DEdge:
    """Bidirected edge between (node, plug) pairs.

    ``key`` is the canonical ordered pair; labels/offsets are stored in the
    canonical direction (from -> to).
    """

    from_node: tuple
    from_plug: int
    to_node: tuple
    to_plug: int
    offsets: list = field(default_factory=list)
    labels: list = field(default_factory=list)
    occ: int = 0
    copy_num: int | None = None

    @property
    def key(self):
        return (self.from_node, self.from_plug, self.to_node, self.to_plug)

    def offset(self) -> int:
        return int(np.median(self.offsets)) if self.offsets else 0

    def label(self) -> str:
        """Representative gap label: median-length observed label
        (ditch_graph/mod.rs:341-404)."""
        if not self.labels:
            return ""
        labs = sorted(self.labels, key=len)
        return labs[len(labs) // 2]


@dataclass
class DNode:
    node: tuple  # (chunk, cluster)
    seq: str
    occ: int = 0
    copy_num: int | None = None


def edge_canonical(n1, p1, n2, p2, offset, label):
    """Canonicalize edge direction; returns (key, offset, label, flipped)."""
    if (n2, p2) < (n1, p1):
        return (n2, p2, n1, p1), offset, _rc(label), True
    return (n1, p1, n2, p2), offset, label, False


class DitchGraph:
    def __init__(self):
        self.nodes: dict[tuple, DNode] = {}
        self.edges: dict[tuple, DEdge] = {}
        self._adj: dict[tuple, set] = defaultdict(set)  # (node, plug) -> edge keys

    # ---------------- construction ----------------

    @classmethod
    def from_encoded_reads(cls, encoded_reads, chunk_seqs: dict,
                           min_span_reads: int = 1) -> "DitchGraph":
        """ditch_graph/mod.rs:406-443."""
        g = cls()
        for er in encoded_reads:
            for n in er.nodes:
                key = (n.chunk, n.cluster)
                if key not in g.nodes:
                    g.nodes[key] = DNode(key, chunk_seqs.get(n.chunk, ""))
                g.nodes[key].occ += 1
        for er in encoded_reads:
            for n1, e, n2 in zip(er.nodes, er.edges, er.nodes[1:]):
                k1 = (n1.chunk, n1.cluster)
                k2 = (n2.chunk, n2.cluster)
                p1 = TAIL if n1.is_forward else HEAD   # exit plug of n1
                p2 = HEAD if n2.is_forward else TAIL   # entry plug of n2
                g.add_edge_observation(k1, p1, k2, p2, e.offset, e.label)
        return g

    def add_edge_observation(self, n1, p1, n2, p2, offset, label):
        key, off, lab, flipped = edge_canonical(n1, p1, n2, p2, offset, label)
        if key not in self.edges:
            self.edges[key] = DEdge(key[0], key[1], key[2], key[3])
            self._adj[(key[0], key[1])].add(key)
            self._adj[(key[2], key[3])].add(key)
        e = self.edges[key]
        e.occ += 1
        e.offsets.append(offset)
        e.labels.append(lab)

    # ---------------- queries ----------------

    def edges_at(self, node, plug):
        return [self.edges[k] for k in self._adj[(node, plug)]
                if k in self.edges]

    def other_end(self, edge: DEdge, node, plug):
        if (edge.from_node, edge.from_plug) == (node, plug):
            return edge.to_node, edge.to_plug
        return edge.from_node, edge.from_plug

    def sanity_check(self):
        """Edge symmetry / adjacency consistency
        (ditch_graph/mod.rs:523-572)."""
        for key, e in self.edges.items():
            assert e.from_node in self.nodes, key
            assert e.to_node in self.nodes, key
            assert key in self._adj[(e.from_node, e.from_plug)]
            assert key in self._adj[(e.to_node, e.to_plug)]

    # ---------------- cleanup ----------------

    def remove_edge(self, key):
        e = self.edges.pop(key, None)
        if e is None:
            return
        self._adj[(e.from_node, e.from_plug)].discard(key)
        self._adj[(e.to_node, e.to_plug)].discard(key)

    def remove_node(self, node):
        for plug in (HEAD, TAIL):
            for key in list(self._adj[(node, plug)]):
                self.remove_edge(key)
            self._adj.pop((node, plug), None)
        self.nodes.pop(node, None)

    def half_edges(self, node, plug):
        """Directed view: [(key, edge, to_node, to_plug)] leaving (node, plug)."""
        out = []
        for k in list(self._adj[(node, plug)]):
            e = self.edges.get(k)
            if e is None:
                continue
            to_n, to_p = self.other_end(e, node, plug)
            out.append((k, e, to_n, to_p))
        return out

    def remove_lightweight_edges(self, thr: int, retain_single_edge: bool = True):
        """Remove edges with occ <= thr at branching plugs
        (ditch_graph/mod.rs:1809-1841): only plugs with >=2 edges are
        considered, and with ``retain_single_edge`` the far endpoint must
        keep an alternative edge with occ > thr."""
        removed_keys = set()
        for node in list(self.nodes.keys()):
            for plug in (HEAD, TAIL):
                hs = self.half_edges(node, plug)
                if len(hs) <= 1:
                    continue
                for k, e, to_n, to_p in hs:
                    if e.occ > thr:
                        continue
                    if retain_single_edge:
                        is_safe = any(f.occ > thr
                                      for f in self.edges_at(to_n, to_p))
                        if not is_safe:
                            continue
                    removed_keys.add(k)
        for k in removed_keys:
            self.remove_edge(k)
        return len(removed_keys)

    def local_coverage(self, node, plug, diag: int) -> float:
        """Average per-copy coverage within ``diag`` steps away from the
        dead-end plug (ditch_graph/mod.rs:1404-1423)."""
        total_cov, total_copy = 0, 0
        current = [(node, plug)]
        for _ in range(diag):
            nxt = set()
            for n, p in current:
                dn = self.nodes.get(n)
                if dn is None:
                    continue
                total_cov += dn.occ
                total_copy += dn.copy_num if dn.copy_num is not None else 1
                other = TAIL if p == HEAD else HEAD
                for _k, _e, tn, tp in self.half_edges(n, other):
                    nxt.add((tn, tp))
            current = sorted(nxt)
        return total_cov / max(total_copy, 1)

    def remove_tips(self, thr: float = 0.8, diag: int = 4):
        """Remove zero-copy dead-end nodes whose occ is below ``thr`` times
        the local per-copy coverage (ditch_graph/mod.rs:1384-1401)."""
        to_remove = []
        for node, dn in self.nodes.items():
            if dn.copy_num != 0:
                continue
            for plug in (HEAD, TAIL):
                if not self.half_edges(node, plug):
                    cov = self.local_coverage(node, plug, diag)
                    if dn.occ < cov * thr:
                        to_remove.append(node)
                    break
        for node in to_remove:
            self.remove_node(node)
        return len(to_remove)

    def remove_zero_copy_elements(self, thr: float = 0.8):
        """Remove zero-copy edges that are weak relative to their plug's
        strongest edge (ditch_graph/mod.rs:893-952).  Nodes whose head/tail
        edge-copy sums disagree ("unsound" estimates) protect all their
        edges; isolated zero-copy nodes are dropped."""
        unsound = set()
        for node in self.nodes:
            sums = [0, 0]
            for plug in (HEAD, TAIL):
                for _k, e, _tn, _tp in self.half_edges(node, plug):
                    if e.copy_num is not None:
                        sums[plug] += e.copy_num
            h, t = sums
            if h != 0 and t != 0 and h != t:
                unsound.add(node)
        ok_to_remove, retain = set(), set()
        for node in self.nodes:
            if node in unsound:
                for plug in (HEAD, TAIL):
                    for k, _e, _tn, _tp in self.half_edges(node, plug):
                        retain.add(k)
                continue
            for plug in (HEAD, TAIL):
                hs = self.half_edges(node, plug)
                mx = max((e.occ for _k, e, _t, _p in hs), default=0)
                for k, e, _tn, _tp in hs:
                    if e.copy_num == 0 and e.occ < thr * max(mx, 1):
                        ok_to_remove.add(k)
                    else:
                        retain.add(k)
        for k in ok_to_remove - retain:
            self.remove_edge(k)
        for node in list(self.nodes.keys()):
            dn = self.nodes[node]
            if dn.copy_num == 0 and not self.half_edges(node, HEAD) \
                    and not self.half_edges(node, TAIL):
                self.remove_node(node)

    # ---------------- path walking ----------------

    def destination(self, to_node, to_plug):
        """Terminal (node, plug) of the simple path entered at (to_node,
        to_plug) (ditch_graph/mod.rs:1250-1282)."""
        cur, pos = to_node, to_plug
        seen = set()
        while True:
            if (cur, pos) in seen:
                break
            seen.add((cur, pos))
            indeg = len(self.half_edges(cur, pos))
            if indeg > 1:
                break
            pos = TAIL if pos == HEAD else HEAD
            outs = self.half_edges(cur, pos)
            if len(outs) != 1:
                break
            _k, _e, cur, pos = outs[0]
        return cur, pos

    def simple_path_from(self, to_node, to_plug):
        """Consumed nodes of the simple path entered at (to_node, to_plug)
        (ditch_graph/mod.rs:1286-1325)."""
        start = to_node
        cur, pos = to_node, to_plug
        nodes = []
        while True:
            if len(self.half_edges(cur, pos)) > 1:
                break
            pos = TAIL if pos == HEAD else HEAD
            nodes.append(cur)
            outs = self.half_edges(cur, pos)
            if len(outs) != 1:
                break
            _k, _e, nxt, npos = outs[0]
            if nxt == start:
                break
            cur, pos = nxt, npos
        return nodes

    def simple_path_and_dest(self, start_node, position):
        """((node, pos) list of the simple path, destinations after it)
        (ditch_graph/mod.rs:1331-1378)."""
        node, pos = start_node, position
        nodes = []
        while True:
            nodes.append((node, pos))
            pos = TAIL if pos == HEAD else HEAD
            outs = self.half_edges(node, pos)
            if len(outs) != 1:
                break
            _k, _e, to_n, to_p = outs[0]
            if len(self.half_edges(to_n, to_p)) > 1 or to_n == start_node:
                break
            node, pos = to_n, to_p
        dests = sorted((to_n, to_p)
                       for _k, _e, to_n, to_p in self.half_edges(node, pos))
        return nodes, dests

    # ---------------- zero-copy path removal ----------------

    def remove_edge_and_pruning(self, from_np, to_np):
        """Remove the edge and recursively prune newly-orphaned zero-copy
        nodes (ditch_graph/mod.rs:1480-1508)."""
        fn_, fp = from_np
        tn, tp = to_np
        for k, _e, on, op in self.half_edges(fn_, fp):
            if (on, op) == (tn, tp):
                self.remove_edge(k)
                break
        dn = self.nodes.get(tn)
        if dn is None:
            return
        if dn.copy_num == 0 and not self.half_edges(tn, tp):
            other = TAIL if tp == HEAD else HEAD
            targets = [(on, op) for _k, _e, on, op in self.half_edges(tn, other)]
            for np_ in targets:
                self.remove_edge_and_pruning((tn, other), np_)
            if tn in self.nodes:
                self.remove_node(tn)

    def remove_zero_copy_path(self, thr: float):
        """Remove zero-copy branch paths whose destinations are a subset of
        their non-zero siblings' destinations and whose coverage ratio is
        below ``thr`` (ditch_graph/mod.rs:957-1032; NB the reference guards
        the loop body with an inverted is_deleted check that makes it a
        no-op — implemented here with the evidently intended semantics)."""
        parents = []
        for node, dn in self.nodes.items():
            if not dn.copy_num:
                continue
            for plug in (HEAD, TAIL):
                hs = self.half_edges(node, plug)
                if len(hs) < 2:
                    continue
                if any(self.nodes.get(tn) is not None
                       and self.nodes[tn].copy_num == 0
                       for _k, _e, tn, _tp in hs):
                    parents.append((node, plug))
        for node, plug in parents:
            if node not in self.nodes:
                continue
            hs = self.half_edges(node, plug)
            if len(hs) <= 1:
                continue
            zc = [(k, e, tn, tp) for k, e, tn, tp in hs
                  if self.nodes.get(tn) is not None
                  and self.nodes[tn].copy_num == 0]
            nzc = [(k, e, tn, tp) for k, e, tn, tp in hs
                   if not (self.nodes.get(tn) is not None
                           and self.nodes[tn].copy_num == 0)]
            if not zc or not nzc:
                continue
            zc_dests = {d[0] for _k, _e, tn, tp in zc
                        for d in self.simple_path_and_dest(tn, tp)[1]}
            nzc_dests = {d[0] for _k, _e, tn, tp in nzc
                         for d in self.simple_path_and_dest(tn, tp)[1]}
            zc_max = max(self.nodes[tn].occ for _k, _e, tn, _tp in zc)
            nzc_max = max((self.nodes[tn].occ for _k, _e, tn, _tp in nzc
                           if tn in self.nodes), default=0)
            ratio = zc_max / nzc_max if nzc_max else 1.0
            if zc_dests <= nzc_dests and ratio < thr:
                for _k, _e, tn, tp in zc:
                    self.remove_edge_and_pruning((node, plug), (tn, tp))

    # ---------------- transitive / z-edge cleanup ----------------

    def transitive_edge_reduction(self):
        """Remove zero-copy edges that are transitive: from (n, p) both to X
        directly and via a sibling edge whose endpoint also reaches X
        (ditch_graph/mod.rs:1034-1075)."""
        removed = set()
        for node in list(self.nodes.keys()):
            for plug in (HEAD, TAIL):
                hs = self.half_edges(node, plug)
                if len(hs) <= 1:
                    continue
                for k, e, tn, tp in hs:
                    if e.copy_num != 0:
                        continue
                    for _k2, _e2, mn, mp in hs:
                        if (mn, mp) == (tn, tp):
                            continue
                        hop = TAIL if mp == HEAD else HEAD
                        if any((gn, gp) == (tn, tp)
                               for _k3, _e3, gn, gp in self.half_edges(mn, hop)):
                            removed.add(k)
                            break
        for k in removed:
            self.remove_edge(k)
        return len(removed)

    def _can_select(self, from_np, to_np):
        """True if keeping only this edge at ``from_np`` cannot disconnect a
        sibling that has no other parent (ditch_graph/mod.rs:1781-1806)."""
        fn_, _fp = from_np
        tn, tp = to_np
        for _k, _e, sn, sp in self.half_edges(tn, tp):
            if sn == fn_:
                continue
            only_parent = all((cn, cp) == (tn, tp)
                              for _k2, _e2, cn, cp in self.half_edges(sn, sp))
            if only_parent:
                return False
        return True

    def z_edge_selection(self):
        """At plugs mixing selectable and non-selectable edges, drop the
        non-selectable ones (Z-shaped crossings, ditch_graph/mod.rs:
        1747-1778)."""
        removed, retained = set(), set()
        for node in list(self.nodes.keys()):
            for plug in (HEAD, TAIL):
                hs = self.half_edges(node, plug)
                flags = [self._can_select((node, plug), (tn, tp))
                         for _k, _e, tn, tp in hs]
                n_sel = sum(flags)
                if 0 < n_sel < len(flags):
                    for (k, _e, _tn, _tp), f in zip(hs, flags):
                        (retained if f else removed).add(k)
        for k in removed - retained:
            self.remove_edge(k)
        return len(removed - retained)

    # ---------------- overclustering zips ----------------

    def zip_up_overclustering(self, max_len: int = 2):
        """Remove one branch of a copy-1 fork whose two arms reconverge at
        the same destination within ``max_len`` nodes
        (ditch_graph/mod.rs:1078-1115)."""
        to_remove = set()
        for node, dn in list(self.nodes.items()):
            if dn.copy_num != 1 or node in to_remove:
                continue
            for plug in (HEAD, TAIL):
                hs = [(k, e, tn, tp)
                      for k, e, tn, tp in self.half_edges(node, plug)
                      if tn not in to_remove]
                if len(hs) != 2:
                    continue
                d0 = self.destination(hs[0][2], hs[0][3])
                d1 = self.destination(hs[1][2], hs[1][3])
                if d0 != d1:
                    continue
                _k, _e, tn, tp = max(hs, key=lambda h: h[1].occ)
                path = self.simple_path_from(tn, tp)
                if len(path) <= max_len:
                    to_remove.update(path)
        for n in to_remove:
            self.remove_node(n)
        return len(to_remove)

    def get_reflex_nodes(self, node, position, cut: int = 6):
        """Reflexive parents/siblings closure of (node, position)
        (ditch_graph/mod.rs:1216-1248)."""
        sibs = [(node, position)]
        parents = []
        for _ in range(cut):
            par_len = len(parents)
            parents = sorted({(tn, tp) for n, p in sibs
                              for _k, _e, tn, tp in self.half_edges(n, p)})
            sib_len = len(sibs)
            sibs = sorted({(tn, tp) for n, p in parents
                           for _k, _e, tn, tp in self.half_edges(n, p)})
            if sib_len == len(sibs) or par_len == len(parents):
                break
        return parents, sibs

    def _merge_into(self, retain, victim):
        """Move all of ``victim``'s edges/occ/copy onto ``retain`` and delete
        it (zip_up_overclustering_dev merging, mod.rs:1117-1163)."""
        rn = self.nodes[retain]
        vn = self.nodes[victim]
        rn.occ += vn.occ
        if rn.copy_num is not None:
            rn.copy_num += vn.copy_num or 0
        moves = []
        for plug in (HEAD, TAIL):
            for k, e, tn, tp in self.half_edges(victim, plug):
                # labels stored in the edge's canonical direction; orient them
                # victim->tn before re-anchoring
                labs = e.labels if (e.from_node, e.from_plug) == (victim, plug) \
                    else [_rc(l) for l in e.labels]
                if tn == victim:  # self-loop becomes retain self-loop
                    tn = retain
                moves.append((plug, tn, tp, list(e.offsets), labs,
                              e.occ, e.copy_num))
                self.remove_edge(k)
        self.remove_node(victim)
        for plug, tn, tp, offs, labs, occ, cp in moves:
            key, _off, _lab, flipped = edge_canonical(
                retain, plug, tn, tp, 0, "")
            if key not in self.edges:
                self.edges[key] = DEdge(key[0], key[1], key[2], key[3])
                self._adj[(key[0], key[1])].add(key)
                self._adj[(key[2], key[3])].add(key)
            e = self.edges[key]
            e.occ += occ
            e.offsets.extend(offs)
            if flipped:
                labs = [_rc(l) for l in labs]
            e.labels.extend(labs)
            if cp is not None:
                e.copy_num = (e.copy_num or 0) + cp

    def zip_up_overclustering_dev(self):
        """Merge sibling nodes of a net-like structure whose both sides see a
        single parent chunk and pairwise-matching sibling chunks
        (ditch_graph/mod.rs:1117-1213)."""
        merged = 0
        for node in sorted(self.nodes.keys()):
            if node not in self.nodes:
                continue
            # self-loop nodes are repeats, not overclustering
            if any(tn == node
                   for plug in (HEAD, TAIL)
                   for _k, _e, tn, _tp in self.half_edges(node, plug)):
                continue
            res = self._zippable(node)
            if res is None:
                continue
            retain, sibs = res
            for s in sibs:
                if s in self.nodes and retain in self.nodes:
                    self._merge_into(retain, s)
                    merged += 1
        return merged

    def _zippable(self, node):
        t_par, t_sibs = self.get_reflex_nodes(node, TAIL, 6)
        h_par, h_sibs = self.get_reflex_nodes(node, HEAD, 6)
        if max(len(t_sibs), len(h_sibs)) <= 1:
            return None
        if not h_par or not t_par:
            return None

        def chunk_pos(np_):
            return (np_[0][0], np_[1])

        if any(chunk_pos(p) != chunk_pos(t_par[0]) for p in t_par):
            return None
        if any(chunk_pos(p) != chunk_pos(h_par[0]) for p in h_par):
            return None
        if len(t_sibs) != len(h_sibs):
            return None
        if any(a[0][0] != b[0][0] for a, b in zip(t_sibs, h_sibs)):
            return None
        sibs = sorted({n for n, _p in t_sibs},
                      key=lambda n: self.nodes[n].occ if n in self.nodes else 0)
        if len(sibs) <= 1:
            return None
        retain = sibs.pop()
        return retain, sibs

    # ---------------- bubbles / nets ----------------

    def collapse_bubble(self):
        """Merge multi-edges from one plug that all reach nodes of the same
        chunk (at the same side) whose only parent is this plug
        (ditch_graph/mod.rs:1539-1690)."""
        from collections import deque
        queue = deque()
        for node in list(self.nodes.keys()):
            queue.append((node, HEAD))
            queue.append((node, TAIL))
        collapsed = 0
        while queue:
            node, plug = queue.popleft()
            if node not in self.nodes:
                continue
            hs = self.half_edges(node, plug)
            if len(hs) <= 1:
                continue
            t0_chunk, t0_pos = hs[0][2][0], hs[0][3]
            if not all(tp == t0_pos and tn[0] == t0_chunk
                       for _k, _e, tn, tp in hs):
                continue
            ok = True
            for _k, _e, tn, tp in hs:
                for _k2, _e2, pn, pp in self.half_edges(tn, tp):
                    if (pn, pp) != (node, plug):
                        ok = False
            if not ok:
                continue
            # merge all children into the max-occ ("primary") one
            hs.sort(key=lambda h: h[1].occ)
            total_occ = sum(h[1].occ for h in hs)
            pk, pe, primary, primary_pos = hs[-1]
            pe.occ = total_occ
            far = TAIL if primary_pos == HEAD else HEAD
            for _k, _e, sec, sec_pos in hs[:-1]:
                if sec in self.nodes and primary in self.nodes:
                    # drop the root->sec edge first so it is not re-anchored
                    for k2, _e2, tn2, tp2 in self.half_edges(sec, sec_pos):
                        if (tn2, tp2) == (node, plug):
                            self.remove_edge(k2)
                    # move far-side edges onto the primary, then delete
                    self.nodes[primary].occ += self.nodes[sec].occ
                    if self.nodes[primary].copy_num is not None:
                        self.nodes[primary].copy_num += \
                            self.nodes[sec].copy_num or 0
                    for k2, e2, tn2, tp2 in self.half_edges(
                            sec, TAIL if sec_pos == HEAD else HEAD):
                        off = e2.offset()
                        lab = e2.label()
                        if (e2.from_node, e2.from_plug) != \
                                (sec, TAIL if sec_pos == HEAD else HEAD):
                            lab = _rc(lab)
                        occ2, cp2 = e2.occ, e2.copy_num
                        self.remove_edge(k2)
                        key, off_c, lab_c, _fl = edge_canonical(
                            primary, far, tn2, tp2, off, lab)
                        if key not in self.edges:
                            self.edges[key] = DEdge(key[0], key[1],
                                                    key[2], key[3])
                            self._adj[(key[0], key[1])].add(key)
                            self._adj[(key[2], key[3])].add(key)
                        e3 = self.edges[key]
                        e3.occ += occ2
                        e3.offsets.append(off_c)
                        e3.labels.append(lab_c)
                        if cp2 is not None:
                            e3.copy_num = (e3.copy_num or 0) + cp2
                    self.remove_node(sec)
                    collapsed += 1
            queue.append((primary, far))
        return collapsed

    def squish_small_net(self, max_len: int = 3):
        """Squish X-crossed short simple paths between long contigs: keep one
        of the crossing small paths (squish_graph.rs:16-95)."""
        from .copy_number import reduce_simple_path
        node_to_pathid, path_nodes, conv_edges, _et, _ip = \
            reduce_simple_path(self)
        P = len(path_nodes)
        slots = [[[], []] for _ in range(P)]
        for fp, fdir, tp, tdir, _occ in conv_edges:
            slots[fp][int(fdir)].append((tp, int(tdir)))
            slots[tp][int(tdir)].append((fp, int(fdir)))
        for s in slots:
            s[0].sort()
            s[1].sort()
        sizes = [n for _w, n in path_nodes]

        def is_net(frm, slot):
            children = slots[frm][slot]
            if len(children) <= 1:
                return None
            if any(sizes[c] > max_len for c, _s in children):
                return None
            c0, c0s = children[0]
            sib = slots[c0][c0s]
            if len(sib) <= 1:
                return None
            if any(slots[c][s] != sib for c, s in children):
                return None
            dest = slots[c0][1 - c0s]
            if any(sizes[d] <= max_len for d, _s in dest):
                return None
            if any(slots[c][1 - s] != dest for c, s in children):
                return None
            return [c for c, _s in children]

        groups = []
        for i in range(P):
            if sizes[i] <= max_len:
                continue
            for slot in (0, 1):
                got = is_net(i, slot)
                if got:
                    groups.append(got)
        seen_groups = []
        for grp in sorted(map(tuple, groups)):
            if grp not in seen_groups:
                seen_groups.append(grp)
        drop_paths = {p for grp in seen_groups for p in grp[1:]}
        to_remove = [n for n, pid in node_to_pathid.items()
                     if pid in drop_paths]
        for n in to_remove:
            self.remove_node(n)
        return len(to_remove)

    def connected_components(self):
        from .find_union import FindUnion
        idx = {n: i for i, n in enumerate(self.nodes)}
        fu = FindUnion(len(idx))
        for e in self.edges.values():
            fu.unite(idx[e.from_node], idx[e.to_node])
        comps = defaultdict(list)
        for n, i in idx.items():
            comps[fu.find(i)].append(n)
        return list(comps.values())

    # ---------------- contig generation ----------------

    def _simple_path_from(self, node, plug, visited):
        """Walk simple path starting by exiting ``node`` through ``plug``."""
        path = [(node, plug)]  # (node, exit plug)
        visited.add(node)
        cur, exit_plug = node, plug
        while True:
            edges = self.edges_at(cur, exit_plug)
            if len(edges) != 1:
                break
            e = edges[0]
            nxt, entry = self.other_end(e, cur, exit_plug)
            if nxt in visited:
                break
            if len(self.edges_at(nxt, entry)) != 1:
                break
            visited.add(nxt)
            exit_plug = TAIL if entry == HEAD else HEAD
            path.append((nxt, exit_plug))
            cur = nxt
        return path

    def spell(self):
        """Traverse simple paths into contigs
        (sequence_generation.rs:261-459).  Returns list of contig dicts:
        seq, summary [(chunk, cluster, strand, occ, copy)], edges walked.
        """
        visited = set()
        contigs = []
        # boundary-first: nodes with a free plug or branching neighbourhood
        def is_boundary(node):
            for plug in (HEAD, TAIL):
                edges = self.edges_at(node, plug)
                if len(edges) == 0:
                    return plug
                if len(edges) > 1:
                    return plug
                e = edges[0]
                on, op = self.other_end(e, node, plug)
                if len(self.edges_at(on, op)) > 1:
                    return plug
            return None

        candidates = sorted(self.nodes.keys())
        for node in candidates:
            if node in visited:
                continue
            bplug = is_boundary(node)
            if bplug is None:
                continue
            # enter at the boundary plug; exit through the other one
            exit_plug = TAIL if bplug == HEAD else HEAD
            path = self._simple_path_from(node, exit_plug, visited)
            contigs.append(self._path_to_contig(path))
        # leftover cycles
        for node in candidates:
            if node not in visited:
                path = self._simple_path_from(node, TAIL, visited)
                contigs.append(self._path_to_contig(path))
        return contigs

    def _path_to_contig(self, path):
        parts = []
        summary = []
        tiles = []  # per-node contig coordinate spans (ContigEncoding
        #             counterpart, sequence_generation.rs:261-459)
        pos = 0
        for i, (node, exit_plug) in enumerate(path):
            dn = self.nodes[node]
            fwd = exit_plug == TAIL  # entered at HEAD -> forward orientation
            seq = dn.seq if fwd else _rc(dn.seq)
            if i == 0:
                parts.append(seq)
                tiles.append({"node": node, "fwd": fwd, "start": pos,
                              "end": pos + len(seq)})
                pos += len(seq)
            else:
                # find connecting edge between prev node and this one
                prev_node, prev_plug = path[i - 1]
                e = None
                for cand in self.edges_at(prev_node, prev_plug):
                    on, op = self.other_end(cand, prev_node, prev_plug)
                    if on == node and op == (HEAD if fwd else TAIL):
                        e = cand
                        break
                off = e.offset() if e else 0
                label = e.label() if e else ""
                if e is not None:
                    # label stored in canonical direction; flip if walking
                    # against it
                    if (e.from_node, e.from_plug) != (prev_node, prev_plug):
                        label = _rc(label)
                if off >= 0:
                    if label:
                        parts.append(label)
                        pos += len(label)
                    parts.append(seq)
                    tiles.append({"node": node, "fwd": fwd, "start": pos,
                                  "end": pos + len(seq)})
                    pos += len(seq)
                else:
                    trimmed = seq[-off:]
                    parts.append(trimmed)
                    tiles.append({"node": node, "fwd": fwd,
                                  "start": pos + off,
                                  "end": pos + len(trimmed)})
                    pos += len(trimmed)
            summary.append((node[0], node[1], fwd, dn.occ,
                            dn.copy_num if dn.copy_num is not None else 1))
        return {"seq": "".join(parts), "summary": summary, "path": path,
                "tiles": tiles}

    def spell_with_paths(self):
        """spell() keeping the raw (node, exit_plug) paths for link emission."""
        return self.spell()

    # ---------------- stats ----------------

    def stats(self):
        return {
            "nodes": len(self.nodes),
            "edges": len(self.edges),
            "total_occ": sum(n.occ for n in self.nodes.values()),
        }
