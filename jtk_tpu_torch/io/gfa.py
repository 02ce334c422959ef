"""GFA emission (reference: the ban-m/gfa crate + assemble/mod.rs:119-253).

Emits GFA 1.0: H header, S segments with LN/cv (coverage) / cp (copy number)
tags, and L links between contig ends, matching the reference's cv:i / cp:i
tag convention.
"""

from __future__ import annotations


def contigs_to_gfa(contigs, links=None, name_prefix: str = "tig") -> str:
    """contigs: list of dicts with 'seq' and 'summary'
    [(chunk, cluster, fwd, occ, copy)].  links: list of
    (i, end_i ('+'/'-'), j, end_j, occ[, offset]) — a negative offset is a
    known overlap of ``-offset`` bp, emitted as the L-line overlap CIGAR."""
    lines = ["H\tVN:Z:1.0"]
    for i, c in enumerate(contigs):
        summary = c.get("summary", [])
        occ = int(sum(s[3] for s in summary) / max(len(summary), 1)) if summary else 0
        cp = int(round(sum(s[4] for s in summary) / max(len(summary), 1))) if summary else 0
        lines.append(
            f"S\t{name_prefix}_{i:04d}\t{c['seq']}\tLN:i:{len(c['seq'])}"
            f"\tcv:i:{occ}\tcp:i:{cp}")
    for link in links or []:
        i, oi, j, oj, occ = link[:5]
        off = link[5] if len(link) > 5 else 0
        ov = f"{-off}M" if off < 0 else "0M"
        lines.append(f"L\t{name_prefix}_{i:04d}\t{oi}\t{name_prefix}_{j:04d}"
                     f"\t{oj}\t{ov}\tcv:i:{occ}")
    # U-groups: contigs grouped by copy number (the reference's GFA2
    # UnorderedGroup records with uid "cp:i:{cp}", assemble/mod.rs:242-249)
    by_cp: dict[int, list] = {}
    for i, c in enumerate(contigs):
        summary = c.get("summary", [])
        cp = int(round(sum(s[4] for s in summary) / max(len(summary), 1))) \
            if summary else 0
        by_cp.setdefault(cp, []).append(f"{name_prefix}_{i:04d}")
    for cp in sorted(by_cp):
        lines.append(f"U\tcp:i:{cp}\t" + " ".join(by_cp[cp]))
    return "\n".join(lines) + "\n"


def contigs_to_gfa2(contigs, links=None, name_prefix: str = "tig") -> str:
    """GFA 2.0 emission — the reference's native dialect (assemble/
    mod.rs:119-253): S lines carry the mandatory <len> column, links become
    E lines with dovetail coordinates ($-terminated at segment ends), and
    copy-number groups are real GFA2 U lines with uid ``cp:i:{cp}``."""
    lines = ["H\tVN:Z:2.0"]
    lens = []
    for i, c in enumerate(contigs):
        summary = c.get("summary", [])
        occ = int(sum(s[3] for s in summary) / max(len(summary), 1)) \
            if summary else 0
        cp = int(round(sum(s[4] for s in summary) / max(len(summary), 1))) \
            if summary else 0
        lens.append(len(c["seq"]))
        lines.append(
            f"S\t{name_prefix}_{i:04d}\t{len(c['seq'])}\t{c['seq']}"
            f"\tcv:i:{occ}\tcp:i:{cp}")

    def dovetail(length: int, orient: str, is_source: bool, ov: int):
        """Interval of the joined end: source '+' / sink '-' sit at the
        segment END, else at the start.  Every coordinate equal to the
        segment length carries the $ end-marker (GFA2 spec)."""
        at_end = (orient == "+") == is_source
        beg, end = (length - ov, length) if at_end else (0, ov)
        mark = lambda p: f"{p}$" if p == length else str(p)
        return f"{mark(beg)}\t{mark(end)}"

    for li, link in enumerate(links or []):
        i, oi, j, oj, occ = link[:5]
        off = link[5] if len(link) > 5 else 0
        ov = -off if off < 0 else 0
        lines.append(
            f"E\tedge_{li}\t{name_prefix}_{i:04d}{oi}"
            f"\t{name_prefix}_{j:04d}{oj}"
            f"\t{dovetail(lens[i], oi, True, ov)}"
            f"\t{dovetail(lens[j], oj, False, ov)}"
            f"\t{str(ov) + 'M' if ov else '*'}\tcv:i:{occ}")
    by_cp: dict[int, list] = {}
    for i, c in enumerate(contigs):
        summary = c.get("summary", [])
        cp = int(round(sum(s[4] for s in summary) / max(len(summary), 1))) \
            if summary else 0
        by_cp.setdefault(cp, []).append(f"{name_prefix}_{i:04d}")
    for cp in sorted(by_cp):
        lines.append(f"U\tcp:i:{cp}\t" + " ".join(by_cp[cp]))
    return "\n".join(lines) + "\n"


def parse_gfa(text: str, with_groups: bool = False):
    """Minimal GFA reader: returns (segments {name: seq, tags}, links[,
    groups {uid: [names]}])."""
    segs, links, groups = {}, [], {}
    for line in text.splitlines():
        f = line.rstrip("\n").split("\t")
        if not f:
            continue
        if f[0] == "S":
            tags = {}
            for t in f[3:]:
                parts = t.split(":", 2)
                if len(parts) == 3:
                    tags[parts[0]] = parts[2]
            segs[f[1]] = {"seq": f[2], "tags": tags}
        elif f[0] == "L":
            links.append((f[1], f[2], f[3], f[4]))
        elif f[0] == "U" and len(f) >= 3:
            groups[f[1]] = f[2].split()
    if with_groups:
        return segs, links, groups
    return segs, links
