"""QPU layout design: coupling graphs, snake paths, annotated renderings.

A copy of ``dtc_tpu/device/layouts.py`` (the port imports nothing of the
JAX package): the exact Eagle 127q, Heron-r1 133q and Garnet 20q coupling
graphs, the generic heavy-hex generator, the simulator's linear chain with
its ancilla, the reference's shipped snake layouts (``REFERENCE_SNAKES``)
and their check against a graph (``validate_snake``), the snake search
(``find_snake_path``, ``find_segmented_snake``, ``snake_layout``) that maps
an L-site chain onto a device, in pure Python, and ``render_layout``
(matplotlib, imported inside it). ``models/device_noise.py`` places its
chains with it.
"""

from __future__ import annotations


# ---------------------------------------------------------------------------
# coupling graphs


def linear_with_ancilla_coupling(L: int, probe_qubit: int | None = None):
    """The simulator coupling map: chain 1..L + ancilla 0 attached at the
    probe site (autocorr-delta-a-single-qiskit-fast.py:159)."""
    q = (L // 2) if probe_qubit is None else probe_qubit
    edges = [(i, i + 1) for i in range(1, L)]
    edges.append((0, q + 1))
    return L + 1, edges


def _heavy_hex_rows(row_cols):
    """Row-major heavy-hex graph from a list of per-row column lists.

    Even entries are long rows (consecutive columns -> chain edges), odd
    entries are connector rows (each qubit bonds to the same column in the
    long rows above/below when present). Returns (n, edges, coords) with
    coords {qubit: (col, row)}.
    """
    coords = {}
    rows = []
    idx = 0
    for r, cols in enumerate(row_cols):
        row = {}
        for c in cols:
            coords[idx] = (c, r)
            row[c] = idx
            idx += 1
        rows.append(row)
    edges = []
    for r, row in enumerate(rows):
        if r % 2 == 0:
            cols = sorted(row)
            for a, b in zip(cols, cols[1:]):
                if b == a + 1:
                    edges.append((row[a], row[b]))
        else:
            for c, qq in row.items():
                if r - 1 >= 0 and c in rows[r - 1]:
                    edges.append((rows[r - 1][c], qq))
                if r + 1 < len(rows) and c in rows[r + 1]:
                    edges.append((qq, rows[r + 1][c]))
    return idx, edges, coords


_A = list(range(0, 13, 4))   # connector columns {0,4,8,12}
_B = list(range(2, 15, 4))   # connector columns {2,6,10,14}
_FULL = list(range(15))


def eagle_coupling():
    """EXACT IBM Eagle 127-qubit graph (Brisbane/Sherbrooke), IBM numbering.

    Row structure from the reference's own coordinate table
    (garnet-normal-layout.py:8-155 / brisbane-normal-layout.py:7-155):
    row 0 = cols 0..13, rows 2..10 = cols 0..14, row 12 = cols 1..14;
    connector rows alternate {0,4,8,12} / {2,6,10,14}.
    """
    return _heavy_hex_rows([
        list(range(14)), _A, _FULL, _B, _FULL, _A, _FULL, _B, _FULL, _A,
        _FULL, _B, list(range(1, 15)),
    ])


def heron_coupling():
    """EXACT IBM Heron-r1 133-qubit graph (Torino), IBM numbering.

    Row structure from the reference's coordinate table
    (torino-autocorr-layout.py:7-156): seven full 15-column rows and SEVEN
    connector rows — unlike Eagle, the end rows are full width and there is
    a trailing connector row 13 at columns {0,4,8,12}.
    """
    return _heavy_hex_rows([
        _FULL, _A, _FULL, _B, _FULL, _A, _FULL, _B, _FULL, _A, _FULL, _B,
        _FULL, _A,
    ])


def heavy_hex_coupling(long_rows: int = 7, width: int = 15):
    """Generic heavy-hex lattice generator (parameterized; for exact device
    graphs in IBM numbering use eagle_coupling()/heron_coupling()).

    `long_rows` rows of `width` qubits (first and last rows are width-1),
    bridged by 4-qubit connector rows.
    """
    rows = []
    idx = 0
    coords = {}
    for r in range(long_rows):
        w = width - 1 if r in (0, long_rows - 1) else width
        x0 = 1 if r == 0 else 0
        row = []
        for c in range(w):
            coords[idx] = (x0 + c, 2 * r)
            row.append(idx)
            idx += 1
        rows.append(row)
        if r < long_rows - 1:
            # connector row: 4 qubits at alternating column phase
            cols = range(0, width, 4) if r % 2 == 1 else range(2, width, 4)
            bridge = []
            for c in cols:
                coords[idx] = (c, 2 * r + 1)
                bridge.append((idx, c))
                idx += 1
            rows.append(bridge)

    n = idx
    edges = []
    for r in range(0, len(rows), 2):
        row = rows[r]
        for a, b in zip(row, row[1:]):
            edges.append((a, b))
    for r in range(1, len(rows), 2):
        above = rows[r - 1]
        below = rows[r + 1]
        above_cols = {coords[q][0]: q for q in above}
        below_cols = {coords[q][0]: q for q in below}
        for q, c in rows[r]:
            if c in above_cols:
                edges.append((above_cols[c], q))
            if c in below_cols:
                edges.append((q, below_cols[c]))
    return n, edges, coords


# EXACT IQM Garnet 20-qubit crystal: the reference's explicit connection
# list (1-indexed there) and rotated-grid coordinates
# (garnet-normal-layout.py:181-201,215-245 — identical in garnet-echo-layout.py).
_GARNET_EDGES_1IDX = (
    (1, 2), (1, 4), (2, 5), (3, 4), (3, 8), (4, 5), (4, 9), (5, 6), (5, 10),
    (6, 7), (6, 11), (7, 12), (8, 9), (8, 13), (9, 10), (9, 14), (10, 11),
    (10, 15), (11, 12), (11, 16), (12, 17), (13, 14), (14, 15), (14, 18),
    (15, 16), (15, 19), (16, 17), (16, 20), (18, 19), (19, 20),
)
_GARNET_COORDS = (
    (6, 4), (5, 5), (6, 2), (5, 3), (4, 4), (3, 5), (2, 6), (5, 1), (4, 2),
    (3, 3), (2, 4), (1, 5), (4, 0), (3, 1), (2, 2), (1, 3), (0, 4), (2, 0),
    (1, 1), (0, 2),
)


def garnet_coupling():
    """EXACT IQM Garnet 20-qubit square-lattice 'crystal', IQM numbering."""
    edges = [(a - 1, b - 1) for a, b in _GARNET_EDGES_1IDX]
    coords = {i: (float(x), float(y)) for i, (x, y) in enumerate(_GARNET_COORDS)}
    return 20, edges, coords


# ---------------------------------------------------------------------------
# the reference's shipped snake layouts (compatibility contract — these exact
# index lists produced the on-disk hardware datasets)

REFERENCE_SNAKES = {
    # L=132 Torino autocorr: entry 0 = ancilla, 1.. = chain
    # (autocorr-delta-a-single-qiskit-fast-ibm.py:179-185, duplicated at
    # torino-autocorr-layout.py:169-175)
    "torino_autocorr": [
        74, 20, 19, 15, 0, 1, 2, 3, 4, 16, 5, 6, 7, 8, 17, 9, 10, 11, 12, 13,
        14, 18, 31, 32, 33, 37, 52, 51, 50, 56, 49, 48, 47, 36, 29, 30, 28,
        27, 26, 25, 35, 24, 23, 22, 21, 34, 40, 41, 39, 38, 53, 57, 58, 59,
        72, 60, 61, 62, 54, 42, 43, 44, 45, 46, 55, 65, 64, 66, 67, 68, 69,
        70, 71, 75, 90, 89, 88, 94, 87, 86, 85, 84, 93, 83, 82, 73, 63, 81,
        80, 92, 79, 78, 77, 76, 91, 95, 96, 97, 110, 98, 99, 100, 101, 111,
        102, 103, 104, 105, 112, 106, 107, 108, 109, 113, 128, 127, 126, 132,
        125, 124, 123, 122, 131, 121, 120, 119, 118, 130, 117, 116, 115, 114,
        129,
    ],
    # L=127 Brisbane energy chain (no ancilla)
    # (brisbane-normal-layout.py:176-197; autocorr-delta-a-single-ibm-energy.py:181-202)
    "brisbane_energy": [
        19, 18, 14, 0, 1, 2, 3, 4, 15, 5, 6, 7, 8, 16, 9, 10, 11, 12, 13,
        17, 30, 31, 32, 36, 51, 50, 49, 55, 48, 47, 46, 35, 28, 29, 27, 26,
        25, 24, 34, 23, 22, 21, 20, 33, 39, 40, 38, 37, 52, 56, 57, 58, 71,
        59, 60, 61, 53, 41, 42, 43, 44, 45, 54, 63, 64, 65, 66, 73, 67, 68,
        69, 70, 74, 89, 88, 87, 93, 86, 85, 84, 83, 92, 82, 81, 72, 62, 80,
        79, 91, 78, 77, 76, 75, 90, 94, 95, 96, 109, 97, 98, 99, 100, 110,
        101, 102, 103, 104, 111, 105, 106, 107, 108, 112, 126, 125, 124, 123,
        122, 121, 120, 119, 118, 117, 116, 115, 114, 113,
    ],
    # L=19 Garnet autocorr: entry 0 = ancilla at physical 14, 1.. = chain
    # (autocorr-delta-a-single-iqm.py:178-201)
    "garnet_autocorr": [
        14, 0, 1, 4, 5, 6, 11, 16, 15, 19, 18, 17, 13, 12, 7, 2, 3, 8, 9, 10,
    ],
}


def validate_snake(path, n, edges, *, distinct=True):
    """Check a snake layout against a coupling graph.

    Returns {"n_hops": number of non-adjacent consecutive pairs,
    "hops": the offending pairs, "in_range": all indices valid,
    "distinct": no repeats} — the reference's own renderers mark
    non-adjacent snake steps with purple arrows (brisbane-normal-layout.py
    renderer), so n_hops quantifies layout quality.
    """
    eset = {frozenset(e) for e in edges}
    hops = [(a, b) for a, b in zip(path, path[1:])
            if frozenset((a, b)) not in eset]
    return {
        "n_hops": len(hops),
        "hops": hops,
        "in_range": all(0 <= x < n for x in path),
        "distinct": len(set(path)) == len(path) or not distinct,
    }


# ---------------------------------------------------------------------------
# snake path search


def _adjacency(n, edges):
    adj = {i: set() for i in range(n)}
    for a, b in edges:
        adj[a].add(b)
        adj[b].add(a)
    return adj


def find_snake_path(n: int, edges, length: int, start: int | None = None,
                    max_steps: int = 2_000_000, best_effort: bool = False):
    """Longest-path (backtracking DFS, fewest-free-neighbors-first heuristic)
    covering `length` nodes; returns the node sequence, or None — unless
    `best_effort`, which returns the longest path found within the budget."""
    adj = _adjacency(n, edges)
    starts = [start] if start is not None else sorted(
        (v for v in adj), key=lambda v: len(adj[v]))
    steps = 0
    best: list = []

    def dfs(path, used):
        nonlocal steps, best
        steps += 1
        if len(path) > len(best):
            best = list(path)
        if steps > max_steps:
            return None
        if len(path) == length:
            return list(path)
        cand = sorted(
            (v for v in adj[path[-1]] if v not in used),
            key=lambda v: len(adj[v] - used),
        )
        for v in cand:
            path.append(v)
            used.add(v)
            r = dfs(path, used)
            if r is not None:
                return r
            path.pop()
            used.remove(v)
        return None

    for s in starts:
        r = dfs([s], {s})
        if r is not None:
            return r
    return best if best_effort else None


def find_segmented_snake(n: int, edges, length: int,
                         max_steps: int = 400_000):
    """Snake layout allowing non-adjacent hops between maximal segments.

    Some device graphs admit no full-length hop-free path at all — on the
    exact Heron 133q graph the four trailing row-13 connectors have degree
    one, so any path contains at most two of them and a 132-node path is
    impossible; the reference's own hand layouts carry such hops (rendered
    as purple arrows, brisbane-normal-layout.py:207-383). This search finds
    maximal hop-free segments greedily and stitches them; a junction whose
    adjoining segments happen to be coupled is not counted as a hop.
    Returns (path, n_hops); the path may be shorter than `length` when the
    device runs out of qubits (callers check).
    """
    adj = _adjacency(n, edges)
    path: list = []
    used: set = set()
    n_hops = 0
    while len(path) < length:
        remaining_nodes = [v for v in adj if v not in used]
        if not remaining_nodes:
            break  # device exhausted: return the partial path
        sub_edges = [(a, b) for a, b in edges
                     if a not in used and b not in used]
        # longest segment within the remaining subgraph (best effort)
        seg = find_snake_path(n, sub_edges, length - len(path),
                              max_steps=max_steps, best_effort=True)
        seg = [v for v in seg if v not in used] if seg else []
        if not seg:
            seg = [remaining_nodes[0]]
        if path and seg[0] not in adj[path[-1]]:
            n_hops += 1
        path.extend(seg[: length - len(path)])
        used.update(seg)
    return path, n_hops


def snake_layout(cfg_or_L, device: str = "brisbane", with_ancilla: bool = True):
    """Map a length-L chain (+ ancilla at the probe site) onto a device.

    Returns dict: {"path": chain snake nodes, "ancilla": physical node or
    None, "n": device size, "edges": coupling list, "coords": positions}.
    """
    L = getattr(cfg_or_L, "L", cfg_or_L)
    if device == "brisbane":
        n, edges, coords = eagle_coupling()
    elif device == "torino":
        n, edges, coords = heron_coupling()
    elif device == "garnet":
        n, edges, coords = garnet_coupling()
    elif device == "linear":
        n, edges = linear_with_ancilla_coupling(L)
        coords = {i: (i, (i * i) / 10.0) for i in range(n)}
        return {"path": list(range(1, L + 1)), "ancilla": 0, "n": n,
                "edges": edges, "coords": coords}
    else:
        raise ValueError(f"unknown device {device!r}")

    path = find_snake_path(n, edges, L)
    n_hops = 0
    if path is None:
        path, n_hops = find_segmented_snake(n, edges, L)
    if len(path) < L:
        raise ValueError(f"no length-{L} snake on {device} ({n} qubits)")
    anc = None
    if with_ancilla:
        adj = {i: set() for i in range(n)}
        for a, b in edges:
            adj[a].add(b)
            adj[b].add(a)
        probe = path[L // 2]
        free = adj[probe] - set(path)
        anc = min(free) if free else None
    return {"path": path, "ancilla": anc, "n": n, "edges": edges,
            "coords": coords, "n_hops": n_hops}


def render_layout(layout: dict, out_png: str, title: str = ""):
    """Annotated topology rendering: chain position on viridis, chain edges
    vs physical-only edges, purple dashed arcs for non-physical snake hops."""
    import os

    from dtc_tpu_torch.analysis.plots import pyplot

    plt = pyplot()

    coords = layout["coords"]
    path = layout["path"]
    pos_in_chain = {q: i for i, q in enumerate(path)}
    fig, ax = plt.subplots(figsize=(10, 7))
    chain_edges = {frozenset(e) for e in zip(path, path[1:])}
    for a, b in layout["edges"]:
        xa, ya = coords[a]
        xb, yb = coords[b]
        in_chain = frozenset((a, b)) in chain_edges
        ax.plot([xa, xb], [ya, yb],
                color="tab:orange" if in_chain else "lightgray",
                lw=2.5 if in_chain else 1.0, zorder=1)
    for a, b in zip(path, path[1:]):
        if frozenset((a, b)) not in {frozenset(e) for e in layout["edges"]}:
            xa, ya = coords[a]
            xb, yb = coords[b]
            ax.annotate("", xy=(xb, yb), xytext=(xa, ya),
                        arrowprops=dict(arrowstyle="->", color="purple",
                                        ls="--", lw=1.2), zorder=2)
    xs = [coords[q][0] for q in coords]
    ys = [coords[q][1] for q in coords]
    cvals = [pos_in_chain.get(q, -1) for q in coords]
    free = [q for q in coords if q not in pos_in_chain]
    ax.scatter([coords[q][0] for q in free], [coords[q][1] for q in free],
               s=60, c="white", edgecolors="gray", zorder=3)
    inpath = [q for q in coords if q in pos_in_chain]
    sc = ax.scatter([coords[q][0] for q in inpath],
                    [coords[q][1] for q in inpath],
                    s=90, c=[pos_in_chain[q] for q in inpath], cmap="viridis",
                    edgecolors="black", zorder=4)
    if layout.get("ancilla") is not None:
        q = layout["ancilla"]
        ax.scatter([coords[q][0]], [coords[q][1]], s=140, marker="s",
                   c="tab:red", edgecolors="black", zorder=5, label="ancilla")
        ax.legend()
    fig.colorbar(sc, ax=ax, label="chain position")
    ax.set_title(title)
    ax.invert_yaxis()
    ax.set_aspect("equal")
    os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
    fig.savefig(out_png, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_png
