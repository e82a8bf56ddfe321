"""Coupling graphs and snake layouts of the devices the noise models mimic.

A copy of the part of ``dtc_tpu/device/layouts.py`` that
``models/device_noise.py`` needs (the port imports nothing of the JAX
package): the exact Eagle 127q, Heron-r1 133q and Garnet 20q coupling
graphs, the simulator's linear chain with its ancilla, and the snake search
(``find_snake_path``, ``find_segmented_snake``, ``snake_layout``) that maps
an L-site chain onto a device, in pure Python. The rest of the reference's
``device/`` (the generic heavy-hex generator, the shipped hand layouts,
their validation and the renderer) is ROADMAP.md queue 1, CLI and edges.
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
