"""Alternative copy-number solvers: Gibbs sampler, MRF MCMC, MST-guided.

References: ``haplotyper/src/copy_number_estimation/copy_number_gibbs.rs``
(annealed-confidence Gibbs sampling with MAP over post-burn-in samples),
``copy_number_mrf.rs`` (Metropolis MCMC with a squared node/edge-sum
consistency potential, annealed temperature and consistency factor), and
``copy_number_mst.rs`` (alternating-structure updates; here realized as
spanning-tree-guided fundamental-cycle toggles — the same move class).

The production algorithm is the min-cost-flow optimizer in
``copy_number.py`` (COPYNUM_ALGORITHM=4); these are the reference's
selectable alternatives (update_copy_numbers.rs:37-46), sharing its
path-level graph inputs: nodes [(coverage, length)], edges
[(from, fdir, to, tdir, coverage)].
"""

from __future__ import annotations

import numpy as np

ERROR_FRAC = 0.25
MAX_CONFIDENCE = 0.95


def _log_poisson(obs: float, cp: int, cov: float) -> float:
    lam = cov * ERROR_FRAC if cp == 0 else cp * cov
    lam = max(lam, 1e-9)
    from .coverage import np as _np  # noqa: F401
    # Stirling-free: obs is small (coverages), use gammaln-free form
    k = np.arange(1, int(obs) + 1)
    denom = float(np.log(k).sum()) if len(k) else 0.0
    return obs * np.log(lam) - lam - denom


def _poisson(obs: float, cp: int, cov: float) -> float:
    return float(np.exp(np.clip(_log_poisson(obs, cp, cov), -600, 600)))


# ---------------------------------------------------------------------------
# Gibbs sampler (copy_number_gibbs.rs)
# ---------------------------------------------------------------------------

class GibbsSampler:
    def __init__(self, node_cov, edges, hap_cov: float):
        self.nodes = np.round(np.asarray(node_cov, float)).astype(np.int64)
        self.edges = [(f, fd, t, td, int(round(w)))
                      for f, fd, t, td, w in edges]
        self.cov = float(hap_cov)
        # per node: edge indices at its plus / minus terminal
        self.terms = [([], []) for _ in range(len(self.nodes))]
        for i, (f, fd, t, td, _w) in enumerate(self.edges):
            self.terms[f][0 if fd else 1].append(i)
            self.terms[t][0 if td else 1].append(i)

    def _choose(self, rng, w, cps, confidence):
        """choose_copy_num (copy_number_gibbs.rs:210-250)."""
        choices = []
        for cp in cps:
            if cp == 0:
                trust = 0.5 + confidence / 2
                choices.append((0, trust * _poisson(w, 0, self.cov)))
                choices.append((1, (1 - trust) * _poisson(w, 1, self.cov)))
            else:
                trust = 1 / 3 + 2 / 3 * confidence
                choices.append((cp, trust * _poisson(w, cp, self.cov)))
                half = (1 - trust) / 2
                choices.append((cp - 1, half * _poisson(w, cp - 1, self.cov)))
                choices.append((cp + 1, half * _poisson(w, cp + 1, self.cov)))
        if choices:
            ws = np.array([c[1] for c in choices])
            s = ws.sum()
            if s <= 0:
                return int(choices[int(rng.integers(len(choices)))][0])
            return int(choices[rng.choice(len(choices), p=ws / s)][0])
        base = int(w // max(self.cov, 1e-9))
        cand = range(max(base - 2, 0), base + 2)
        return max(cand, key=lambda cp: _poisson(w, cp, self.cov))

    def _update_nodes(self, rng, node_cp, edge_cp, conf):
        for n in rng.permutation(len(self.nodes)):
            cps = []
            down, up = self.terms[n]
            if down:
                cps.append(int(sum(edge_cp[j] for j in down)))
            if up:
                cps.append(int(sum(edge_cp[j] for j in up)))
            node_cp[n] = self._choose(rng, self.nodes[n], cps, conf)

    def _update_edges(self, rng, node_cp, edge_cp, conf):
        for e in rng.permutation(len(self.edges)):
            f, fd, t, td, w = self.edges[e]
            cps = [self._slack(e, f, fd, node_cp, edge_cp),
                   self._slack(e, t, td, node_cp, edge_cp)]
            edge_cp[e] = self._choose(rng, w, cps, conf)

    def _slack(self, e, node, is_plus, node_cp, edge_cp):
        sib = self.terms[node][0 if is_plus else 1]
        tot = sum(edge_cp[j] for j in sib)
        return max(node_cp[node] + edge_cp[e] - tot, 0)

    def sample(self, seed: int = 4382094, burn_in: int = 2000,
               sample_len: int = 2000):
        rng = np.random.default_rng(seed)
        node_cp = np.round(self.nodes / max(self.cov, 1e-9)).astype(np.int64)
        edge_cp = np.array([int(round(w / max(self.cov, 1e-9)))
                            for _f, _fd, _t, _td, w in self.edges], np.int64)
        for i in range(burn_in):
            conf = i * MAX_CONFIDENCE / burn_in
            self._update_nodes(rng, node_cp, edge_cp, conf)
            self._update_edges(rng, node_cp, edge_cp, conf)
        for _ in range(burn_in):
            self._update_nodes(rng, node_cp, edge_cp, MAX_CONFIDENCE)
            self._update_edges(rng, node_cp, edge_cp, MAX_CONFIDENCE)
        ndist = [np.zeros(2 * (c + 1), np.int64) for c in node_cp]
        edist = [np.zeros(2 * (c + 1), np.int64) for c in edge_cp]
        for _ in range(sample_len):
            self._update_nodes(rng, node_cp, edge_cp, MAX_CONFIDENCE)
            self._update_edges(rng, node_cp, edge_cp, MAX_CONFIDENCE)
            for buf, x in zip(ndist, node_cp):
                if x < len(buf):
                    buf[x] += 1
            for buf, x in zip(edist, edge_cp):
                if x < len(buf):
                    buf[x] += 1
        return (np.array([int(b.argmax()) for b in ndist]),
                np.array([int(b.argmax()) for b in edist]))


def estimate_copy_number_gbs(node_cov, edges, cov,
                             burn_in: int = 2000, sample_len: int = 2000):
    g = GibbsSampler(node_cov, edges, cov)
    return g.sample(burn_in=burn_in, sample_len=sample_len)


# ---------------------------------------------------------------------------
# MRF MCMC (copy_number_mrf.rs)
# ---------------------------------------------------------------------------

class MRFGraph:
    def __init__(self, edges, coverages):
        """edges: [(u, u_is_head, v, v_is_head)]; coverages: [(cov, len)]."""
        self.edges = list(edges)
        self.covs = [(int(round(c)), int(l)) for c, l in coverages]
        self.edge_lists = [[[], []] for _ in range(len(self.covs))]
        for i, (u, uh, v, vh) in enumerate(self.edges):
            self.edge_lists[u][1 if uh else 0].append(i)
            self.edge_lists[v][1 if vh else 0].append(i)

    def _node_pot(self, w, cp, cov):
        lam = max(cp * cov, cov * ERROR_FRAC)
        return -w * np.log(lam) + lam

    def total_energy(self, node_cp, edge_cp, cov, consist):
        pot = sum(l * self._node_pot(w, c, cov)
                  for (w, l), c in zip(self.covs, node_cp))
        cons = 0
        for eds, cp in zip(self.edge_lists, node_cp):
            for side in (0, 1):
                if eds[side]:
                    s = sum(edge_cp[j] for j in eds[side])
                    cons += (cp - s) ** 2
        return pot + cons * consist

    def map_estimate(self, rng, cov, burn_in: int = 2000,
                     target_consist: float = 20.0):
        node_cp = np.array([int(np.floor(w / cov))
                            + int(rng.random() < (w / cov) % 1)
                            for w, _l in self.covs], np.int64)
        edge_cp = np.zeros(len(self.edges), np.int64)
        for i, (u, _uh, _v, _vh) in enumerate(self.edges):
            edge_cp[i] = max(int(round(self.covs[u][0] / cov / 2)), 0)
        total_step = max(2 * (len(node_cp) + len(edge_cp)) * burn_in, 1)
        consist = 1.0
        grad = np.exp(np.log(target_consist) / total_step)
        temp = 100.0
        chill = np.exp(np.log(100.0) / total_step)
        for _ in range(total_step):
            self._update(rng, node_cp, edge_cp, cov, consist, temp)
            consist *= grad
            temp /= chill
        best = self.total_energy(node_cp, edge_cp, cov, consist)
        argmin = (node_cp.copy(), edge_cp.copy())
        for _ in range(1000):
            if self._update(rng, node_cp, edge_cp, cov, consist, temp):
                pot = self.total_energy(node_cp, edge_cp, cov, consist)
                if pot < best:
                    best = pot
                    argmin = (node_cp.copy(), edge_cp.copy())
        return argmin, best

    def _update(self, rng, node_cp, edge_cp, cov, consist, temp) -> bool:
        kind = int(rng.integers(3))
        dec = bool(rng.random() < 0.5)
        d = -1 if dec else 1
        if kind == 0 and len(node_cp):
            i = int(rng.integers(len(node_cp)))
            if node_cp[i] == 0 and dec:
                return True
            e0 = self.total_energy(node_cp, edge_cp, cov, consist)
            node_cp[i] += d
            diff = self.total_energy(node_cp, edge_cp, cov, consist) - e0
            if diff <= 0 or rng.random() < np.exp(-diff / temp):
                return True
            node_cp[i] -= d
            return False
        if kind == 1 and len(edge_cp):
            i = int(rng.integers(len(edge_cp)))
            if edge_cp[i] == 0 and dec:
                return True
            e0 = self.total_energy(node_cp, edge_cp, cov, consist)
            edge_cp[i] += d
            diff = self.total_energy(node_cp, edge_cp, cov, consist) - e0
            if diff <= 0 or rng.random() < np.exp(-diff / temp):
                return True
            edge_cp[i] -= d
            return False
        if len(node_cp) == 0:
            return False
        # coupled neighbor move: the node and one incident edge per side
        i = int(rng.integers(len(node_cp)))
        if node_cp[i] == 0 and dec:
            return True
        picks = []
        for side in (0, 1):
            eds = self.edge_lists[i][side]
            if eds:
                j = eds[int(rng.integers(len(eds)))]
                if dec and edge_cp[j] == 0:
                    return False
                picks.append(j)
        e0 = self.total_energy(node_cp, edge_cp, cov, consist)
        node_cp[i] += d
        for j in picks:
            edge_cp[j] += d
        diff = self.total_energy(node_cp, edge_cp, cov, consist) - e0
        if diff <= 0 or rng.random() < np.exp(-diff / temp):
            return True
        node_cp[i] -= d
        for j in picks:
            edge_cp[j] -= d
        return False


def estimate_copy_number_mcmc(node_cov_len, edges, cov, seed: int = 42,
                              chains: int = 4, burn_in: int = 500):
    """Multi-chain MRF MAP estimate (estimate_copy_number_mcmc,
    copy_number_gibbs.rs:253-282; chain count reduced from 56)."""
    mrf_edges = [(u, uh, v, vh) for u, uh, v, vh, _w in edges]
    covs = [(c, l) for c, l in node_cov_len]
    g = MRFGraph(mrf_edges, covs)
    rng = np.random.default_rng(seed)
    best, arg = None, None
    for _ in range(chains):
        chain_rng = np.random.default_rng(int(rng.integers(2 ** 63)))
        (ncp, ecp), pot = g.map_estimate(chain_rng, cov, burn_in=burn_in)
        if best is None or pot < best:
            best, arg = pot, (ncp, ecp)
    return arg


# ---------------------------------------------------------------------------
# MST-guided (copy_number_mst.rs move class)
# ---------------------------------------------------------------------------

def estimate_copy_number_mst(node_cov_len, edges, cov, seed: int = 42,
                             rounds: int = 50):
    """Spanning-tree-guided alternating-cycle updates.

    Vertices are node plugs (2 per path node, like the reference's FatEdge
    2i/2i+1 packing); every element (node or connecting edge) is an edge of
    that plug graph carrying a copy number.  Each round builds a spanning
    forest weighted by |cov - cp*hap_cov| residuals and toggles the
    fundamental cycle of the worst non-tree element when the coordinated
    +-1 along the cycle lowers the squared-residual objective — the same
    alternating-structure move class as the reference, realized with a
    simpler selection rule."""
    rng = np.random.default_rng(seed)
    N = len(node_cov_len)
    elems = []   # (u, v, target, weight_len)
    for i, (c, l) in enumerate(node_cov_len):
        elems.append((2 * i, 2 * i + 1, float(c), int(l)))
    for (f, fd, t, td, w) in edges:
        u = 2 * f + (0 if fd else 1)
        v = 2 * t + (0 if td else 1)
        elems.append((u, v, float(w), 1))
    cp = np.array([max(int(round(e[2] / max(cov, 1e-9))), 0)
                   for e in elems], np.int64)

    def obj():
        return sum(l * (t - c * cov) ** 2
                   for (u, v, t, l), c in zip(elems, cp))

    n_vert = 2 * N
    for _ in range(rounds):
        # spanning forest over elements ordered by how well they fit
        resid = np.array([abs(t - c * cov)
                          for (_u, _v, t, _l), c in zip(elems, cp)])
        order = np.argsort(resid + rng.random(len(elems)) * 1e-6)
        parent = list(range(n_vert))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        tree_adj = [[] for _ in range(n_vert)]
        non_tree = []
        for ei in order:
            u, v = elems[ei][0], elems[ei][1]
            ru, rv = find(u), find(v)
            if ru != rv:
                parent[ru] = rv
                tree_adj[u].append((v, ei))
                tree_adj[v].append((u, ei))
            else:
                non_tree.append(ei)
        improved = False
        for ei in sorted(non_tree, key=lambda e: -resid[e]):
            u, v = elems[ei][0], elems[ei][1]
            path = _tree_path(tree_adj, u, v)
            if path is None:
                continue
            cycle = [ei] + path
            for d in (1, -1):
                if d < 0 and any(cp[e] == 0 for e in cycle):
                    continue
                delta = 0.0
                for e in cycle:
                    _u, _v, t, l = elems[e]
                    c = cp[e]
                    delta += l * ((t - (c + d) * cov) ** 2 - (t - c * cov) ** 2)
                if delta < -1e-9:
                    for e in cycle:
                        cp[e] += d
                    improved = True
                    break
        if not improved:
            break
    node_cp = cp[:N].copy()
    edge_cp = cp[N:].copy()
    return node_cp, edge_cp


def _tree_path(tree_adj, u, v, limit: int = 10000):
    """Element indices along the tree path u -> v (BFS)."""
    from collections import deque
    prev = {u: (None, None)}
    dq = deque([u])
    steps = 0
    while dq and steps < limit:
        x = dq.popleft()
        if x == v:
            path = []
            while x != u:
                px, pe = prev[x]
                path.append(pe)
                x = px
            return path
        for y, ei in tree_adj[x]:
            if y not in prev:
                prev[y] = (x, ei)
                dq.append(y)
        steps += 1
    return None
