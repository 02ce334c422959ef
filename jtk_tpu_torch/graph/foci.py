"""Repeat resolution by foci — duplicate multi-copy nodes along spanning reads.

Reference: ``haplotyper/src/assemble/ditch_graph/repeat_resolve_by_focus.rs``:
for each copy-1 node flowing into a branching / multi-copy region, reads
through it are tallied into per-distance (chunk, cluster) count tables
(count_dist_nodes :663-703); a graph-guided BFS over copy>0 edges collects
candidate nodes per distance with backpath parents (traverse :705-760); each
distance's copy-1 candidates get a likelihood-ratio test of "true successor"
(concentration 1-ERROR_PROB, lk_pairs :727-738) against a coverage-normalized
null (:740-756), producing Focus records (retrieve_foci :674-708); foci pass
to_multi_copy / branching gates and the optional bidirectional-match filter
(get_foci :286-341); survey_foci applies them best-LLR-first, duplicating the
path nodes with copy/occ splits and pruning exhausted zero-copy elements
(survey_foci/duplicate_along/remove_along :90-246).  bypass_repeats pairs the
two entries/exits of copy-2 paths by read counts (:342-481).

Cloned nodes get keys (chunk, cluster, dup_id); key[:2] is the
(chunk, cluster) identity everywhere reads are matched.
"""

from __future__ import annotations

import logging
import math
from collections import defaultdict

from .ditch_graph import HEAD, TAIL, DNode, DitchGraph

logger = logging.getLogger(__name__)

ERROR_PROB = 0.1
MIN_PROB = 0.001


def _opp(p):
    return TAIL if p == HEAD else HEAD


def _ident(key):
    return (key[0], key[1])


class Focus:
    __slots__ = ("from_key", "from_pos", "to_key", "to_pos", "dist", "llr",
                 "counts", "path")

    def __init__(self, from_key, from_pos, to_key, to_pos, dist, llr,
                 counts, path):
        self.from_key = from_key
        self.from_pos = from_pos
        self.to_key = to_key
        self.to_pos = to_pos
        self.dist = dist
        self.llr = llr
        self.counts = counts
        self.path = path   # [(node_key, entry_pos)] ending at to_key


def _lk_pairs(n: int):
    correct = (1 - ERROR_PROB) ** 2 + ERROR_PROB / n
    error = (1 - ERROR_PROB) * ERROR_PROB / max(n - 1, 1) + ERROR_PROB / n
    return math.log(correct), math.log(max(error, 1e-300))


def _copy(g, key):
    n = g.nodes.get(key)
    return n.copy_num if n and n.copy_num is not None else None


def count_dist_nodes(g, reads, node_key, pos):
    """Per-distance Counter of (chunk, cluster) among reads through
    ``node_key`` leaving via ``pos`` (count_dist_nodes :663-703)."""
    ident = _ident(node_key)
    tables = defaultdict(lambda: defaultdict(int))
    for er in reads:
        try:
            start = next(i for i, n in enumerate(er.nodes)
                         if (n.chunk, n.cluster) == ident)
        except StopIteration:
            continue
        fwd = er.nodes[start].is_forward
        if (fwd and pos == TAIL) or (not fwd and pos == HEAD):
            walk = er.nodes[start:]
        else:
            walk = er.nodes[:start + 1][::-1]
        for d, n in enumerate(walk):
            tables[d][(n.chunk, n.cluster)] += 1
    return tables


def _traverse(g, reads, node_key, pos, min_span):
    """BFS over copy>0 edges with per-distance counts + backpath parents
    (traverse :705-760).  Entry i at distance d is
    (count, max_so_far, parent_idx, node_key, entry_pos)."""
    tables = count_dist_nodes(g, reads, node_key, pos)
    levels = [[(0, 0, 0, node_key, _opp(pos))]]
    for dist in range(0, 64):
        prev = levels[dist]
        found = set()
        for _c, _m, _p, key, epos in prev:
            for _k, e, tn, tp in g.half_edges(key, _opp(epos)):
                if e.copy_num is not None and e.copy_num > 0:
                    found.add((tn, tp))
        found = sorted(found)
        if not found:
            break
        loc = {np_: i for i, np_ in enumerate(found)}
        nxt = []
        for key, epos in found:
            c = tables.get(dist + 1, {}).get(_ident(key), 0)
            nxt.append([c, c, 0, key, epos])
        for i, (_c, mx, _p, key, epos) in enumerate(prev):
            for _k, e, tn, tp in g.half_edges(key, _opp(epos)):
                if not (e.copy_num is not None and e.copy_num > 0):
                    continue
                j = loc.get((tn, tp))
                if j is None:
                    continue
                if nxt[j][1] < mx + nxt[j][0]:
                    nxt[j][1] = mx + nxt[j][0]
                    nxt[j][2] = i
        if sum(x[0] for x in nxt) < min_span:
            break
        levels.append([tuple(x) for x in nxt])
    return levels


def _max_lk_node(g, entries):
    """(llr, (key, pos)) of the best copy-1 candidate (max_lk_node
    :636-661)."""
    occs, keys = [], []
    for c, _m, _p, key, epos in entries:
        dn = g.nodes.get(key)
        if dn is not None and dn.occ > 0:
            occs.append(c)
            keys.append((key, epos, dn))
    if len(occs) < 2:
        return None
    total_occ = sum(dn.occ for _k, _p, dn in keys)
    null = [math.log(max(dn.occ / total_occ, MIN_PROB))
            for _k, _p, dn in keys]
    null_lk = sum(o * p for o, p in zip(occs, null) if o > 0)
    correct, error = _lk_pairs(len(occs))
    best = None
    tot = sum(occs)
    for k, (key, epos, dn) in enumerate(keys):
        if dn.copy_num != 1:
            continue
        lk = occs[k] * correct + (tot - occs[k]) * error
        llr = lk - null_lk
        if best is None or llr > best[0]:
            best = (llr, (key, epos))
    return best


def _trackback(levels, dist, target):
    """Backpath [(key, entry_pos)] from distance 1..dist (trackback
    :654-672)."""
    idx = next(i for i, e in enumerate(levels[dist])
               if (e[3], e[4]) == target)
    path = []
    d = dist
    while d > 0:
        e = levels[d][idx]
        path.append((e[3], e[4]))
        idx = e[2]
        d -= 1
    path.reverse()
    return path


def _to_multi_copy(g, key, pos):
    hs = g.half_edges(key, pos)
    if len(hs) != 1:
        return False
    _k, _e, tn, tp = hs[0]
    if len(g.half_edges(tn, tp)) == 1:
        return False
    cp = _copy(g, tn)
    return cp is not None and cp > 1


def retrieve_foci(g, key, pos, reads, min_span):
    node_reads = [er for er in reads
                  if any((n.chunk, n.cluster) == _ident(key)
                         for n in er.nodes)]
    levels = _traverse(g, node_reads, key, pos, min_span)
    out = []
    for d in range(1, len(levels)):
        got = _max_lk_node(g, levels[d])
        if got is None:
            continue
        llr, (to_key, to_pos) = got
        if llr <= 0.01:
            continue
        path = _trackback(levels, d, (to_key, to_pos))
        counts = [e[0] for e in levels[d]]
        out.append(Focus(key, pos, to_key, to_pos, d, llr, counts, path))
    return out


def get_foci(g, reads, use_branch, thr, bimatch, min_span):
    foci = defaultdict(list)
    for key, dn in list(g.nodes.items()):
        if dn.copy_num != 1:
            continue
        for pos in (HEAD, TAIL):
            branching = len(g.half_edges(key, pos)) > 1
            if _to_multi_copy(g, key, pos) or (use_branch and branching):
                got = [f for f in retrieve_foci(g, key, pos, reads, min_span)
                       if f.llr > thr]
                foci[key].extend(got)
    if bimatch:
        for key in list(foci.keys()):
            kept = []
            for f in foci[key]:
                revs = foci.get(f.to_key, [])
                if any(r.to_key == f.from_key for r in revs):
                    kept.append(f)
            foci[key] = kept
    out = []
    for key, fs in foci.items():
        if fs:
            out.append(max(fs, key=lambda f: f.llr))
    return out


# ---------------- applying foci ----------------

def _is_path_branching(g, focus):
    if len(g.half_edges(focus.from_key, focus.from_pos)) > 1:
        return True
    for key, _pos in focus.path[:-1]:
        for p in (HEAD, TAIL):
            if len(g.half_edges(key, p)) > 1:
                return True
    if focus.path:
        key, pos = focus.path[-1]
        if len(g.half_edges(key, pos)) > 1:
            return True
    return False


def _decrement_node(g, key):
    dn = g.nodes.get(key)
    if dn is None or not dn.copy_num:
        return 0
    share = dn.occ // dn.copy_num
    dn.occ -= share
    dn.copy_num -= 1
    return share


def _decrement_edge(g, from_np, to_np):
    fn_, fp = from_np
    tn, tp = to_np
    for _k, e, on, op in g.half_edges(fn_, fp):
        if (on, op) == (tn, tp):
            if e.copy_num and e.copy_num > 0:
                share = e.occ // e.copy_num
                e.occ -= share
                e.copy_num -= 1
                return share
            return 0
    return 0


def _find_edge(g, from_np, to_np):
    fn_, fp = from_np
    tn, tp = to_np
    for _k, e, on, op in g.half_edges(fn_, fp):
        if (on, op) == (tn, tp):
            return e
    return None


def _duplicate_along(g, focus, dup_counter):
    """duplicate_along (:140-195): clone every interior path node with
    copy/occ splits, rewiring a fresh copy-1 chain from the focus to the
    target."""
    from .ditch_graph import edge_canonical, DEdge, _rc
    c_key, c_pos = focus.from_key, focus.from_pos
    prev_key = focus.from_key
    prev_exit = focus.from_pos
    new_nodes = []
    for i, (to_key, to_pos) in enumerate(focus.path):
        last = i + 1 == len(focus.path)
        oe = _find_edge(g, (c_key, c_pos), (to_key, to_pos))
        off = oe.offset() if oe else 0
        lab = oe.label() if oe else ""
        if oe is not None and (oe.from_node, oe.from_plug) != (c_key, c_pos):
            lab = _rc(lab)
        if last:
            new_key = to_key
        else:
            orig = g.nodes[to_key]
            share = _decrement_node(g, to_key)
            dup_counter[to_key] = dup_counter.get(to_key, 0) + 1
            new_key = (to_key[0], to_key[1], dup_counter[to_key])
            g.nodes[new_key] = DNode(new_key, orig.seq, occ=share,
                                     copy_num=1)
            new_nodes.append(new_key)
        edge_occ = _decrement_edge(g, (c_key, c_pos), (to_key, to_pos))
        key, off_c, lab_c, _fl = edge_canonical(prev_key, prev_exit,
                                                new_key, to_pos, off, lab)
        if key not in g.edges:
            g.edges[key] = DEdge(key[0], key[1], key[2], key[3])
            g._adj[(key[0], key[1])].add(key)
            g._adj[(key[2], key[3])].add(key)
        e = g.edges[key]
        e.occ += max(edge_occ, 1)
        e.offsets.append(off_c)
        e.labels.append(lab_c)
        e.copy_num = 1
        c_key, c_pos = to_key, _opp(to_pos)
        prev_key, prev_exit = new_key, _opp(to_pos)
    return new_nodes


def _remove_node_recursive(g, key):
    dn = g.nodes.get(key)
    if dn is None or dn.copy_num != 0:
        return
    edges = [(k, e, tn, tp) for p in (HEAD, TAIL)
             for k, e, tn, tp in g.half_edges(key, p)]
    if any(not (e.copy_num == 0) for _k, e, _tn, _tp in edges):
        return
    neighbors = sorted({tn for _k, _e, tn, _tp in edges})
    for k, _e, _tn, _tp in edges:
        g.remove_edge(k)
    g.remove_node(key)
    for nb in neighbors:
        _remove_node_recursive(g, nb)


def _remove_along(g, focus):
    """remove_along (:186-246): drop exhausted zero-copy edges on/next to
    the path, then recursively prune zero-copy nodes."""
    prev, prev_pos = focus.from_key, focus.from_pos
    for key, pos in focus.path:
        e = _find_edge(g, (prev, prev_pos), (key, pos))
        if e is not None and e.copy_num == 0:
            g.remove_edge(e.key)
        prev, prev_pos = key, _opp(pos)
    affected = set()
    zero_edges = [k for k, e, _tn, _tp in
                  g.half_edges(focus.from_key, focus.from_pos)
                  if e.copy_num == 0]
    for key, _pos in focus.path:
        for p in (HEAD, TAIL):
            zero_edges.extend(k for k, e, _tn, _tp in g.half_edges(key, p)
                              if e.copy_num == 0)
    for k in set(zero_edges):
        e = g.edges.get(k)
        if e is not None:
            affected.update([e.from_node, e.to_node])
            g.remove_edge(k)
    affected.update(k for k, _p in focus.path)
    for key in affected:
        _remove_node_recursive(g, key)


def survey_foci(g, foci, dup_counter) -> int:
    foci = sorted(foci, key=lambda f: (-f.llr, -f.dist))
    solved = 0
    touched = set()
    for f in foci:
        if any(k in touched for k, _p in f.path):
            continue
        if _copy(g, f.from_key) != 1 or _copy(g, f.to_key) != 1:
            continue
        hs = g.half_edges(f.from_key, f.from_pos)
        if len(hs) != 1:
            continue
        _k, _e, tn, tp = hs[0]
        if len(g.half_edges(tn, tp)) <= 1:
            continue
        if not _is_path_branching(g, f):
            continue
        logger.info("FOCUS\t%s\t%s\t->%s\tllr=%.1f\tdist=%d",
                    f.from_key, f.from_pos, f.to_key, f.llr, f.dist)
        new_nodes = _duplicate_along(g, f, dup_counter)
        touched.update(new_nodes)
        touched.update(k for k, _p in f.path)
        touched.add(f.from_key)
        _remove_along(g, f)
        solved += 1
    return solved


def resolve_repeats(g: DitchGraph, encoded_reads, min_span: int = 2,
                    llr_thr: float = 1.0, bimatch: bool = True,
                    use_branch: bool = False, max_rounds: int = 20) -> int:
    """resolve_repeats (:247-269): repeatedly find + apply foci above the
    LLR threshold until none succeed."""
    dup_counter: dict = {}
    applied = 0
    for _ in range(max_rounds):
        foci = get_foci(g, encoded_reads, use_branch, llr_thr, bimatch,
                        min_span)
        n = survey_foci(g, foci, dup_counter)
        applied += n
        if n == 0:
            break
    return applied


# ---------------- bypass_repeats ----------------

def _traverse_diplo_path(g, key):
    """(head_dests, path, tail_dests) around the copy-2 simple path through
    ``key`` (traverse_diplo_path :420-444)."""
    _nodes, head_dests = g.simple_path_and_dest(key, TAIL)
    head_dests = sorted(head_dests)
    if not head_dests:
        return None
    h_key, h_pos = head_dests[0]
    hs = g.half_edges(h_key, h_pos)
    if len(hs) != 1:
        return None
    _k, _e, root, root_pos = hs[0]
    path, tail_dests = g.simple_path_and_dest(root, root_pos)
    return head_dests, path, sorted(tail_dests)


def _count_pairs(g, heads, tails, reads):
    hk = [_ident(k) for k, _p in heads]
    tk = [_ident(k) for k, _p in tails]
    counts = [0, 0, 0, 0]
    for er in reads:
        hh = [hk.index((n.chunk, n.cluster)) for n in er.nodes
              if (n.chunk, n.cluster) in hk]
        tt = [tk.index((n.chunk, n.cluster)) for n in er.nodes
              if (n.chunk, n.cluster) in tk]
        for hi in hh:
            for ti in tt:
                counts[(hi << 1) + ti] += 1
    return counts


def bypass_repeats(g: DitchGraph, encoded_reads, llr_thr: float = 1.0,
                   min_span: int = 2, max_rounds: int = 10) -> int:
    """bypass_repeats (:237-246, :342-481): pair the two entries and exits
    of 2-in/2-out copy-2 paths by spanning-read counts and connect the
    matched pairs through duplicated path copies."""
    dup_counter: dict = {}
    applied = 0
    for _ in range(max_rounds):
        bypasses = []
        checked = set()
        for key, dn in list(g.nodes.items()):
            if dn.copy_num != 2 or key in checked:
                continue
            got = _traverse_diplo_path(g, key)
            if got is None:
                continue
            heads, path, tails = got
            if len(heads) != 2 or len(tails) != 2 or heads == tails:
                continue
            checked.update(k for k, _p in path)
            idents = {_ident(k) for k, _p in path}
            touching = [er for er in encoded_reads
                        if any((n.chunk, n.cluster) in idents
                               for n in er.nodes)]
            counts = _count_pairs(g, heads, tails, touching)
            if sum(counts) < min_span:
                continue
            h0t0, h0t1, h1t0, h1t1 = counts
            to_np = None
            if h0t1 + h1t0 + min_span <= h0t0 + h1t1 \
                    and h0t1 + h1t0 <= min_span:
                to_np = tails[0]
            elif h0t0 + h1t1 + min_span <= h1t0 + h0t1 \
                    and h0t0 + h1t1 <= min_span:
                to_np = tails[1]
            if to_np is None:
                continue
            from_key, from_pos = heads[0]
            fpath = list(path) + [to_np]
            bypasses.append(Focus(from_key, from_pos, to_np[0], to_np[1],
                                  len(path) + 1, llr_thr + 1.0, counts,
                                  fpath))
        n = survey_foci(g, bypasses, dup_counter)
        applied += n
        if n == 0:
            break
    return applied
