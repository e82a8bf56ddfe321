"""Device-noise models: the FakeBrisbane / IQMFakeGarnet analogue.

A copy of ``dtc_tpu/models/device_noise.py`` (``DeviceNoiseModel``, the
synthetic Eagle and Garnet calibrations, ``qiskit_properties_to_calibration``,
``load_calibration``, ``model_from_calibration``, ``brisbane_like_model``,
``garnet_like_model``, ``fake_device_model``); numpy only, the layouts from
the port's own copy (``dtc_tpu_torch/device/layouts.py``).

A calibration (per-qubit 1q error, per-edge 2q error, readout error) maps
onto the chain through a snake layout, giving p_1q (L,) per kick gate and
site, p_2q (L-1,) per chain bond and RZZ sublayer, and readout (L,) (+ the
ancilla's) assignment errors, applied as exact (1 - 2 eps) contractions.
A synthetic Eagle-class calibration (typical magnitudes, deterministic
seed) stands in for FakeBrisbane's snapshot; any real calibration JSON in
this schema, or a Qiskit BackendProperties snapshot, can be loaded.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np


@dataclasses.dataclass(frozen=True)
class DeviceNoiseModel:
    p_1q: np.ndarray          # (L,)
    p_2q: np.ndarray          # (L-1,) per chain bond
    readout: np.ndarray       # (L,)
    readout_ancilla: float = 0.0

    @property
    def L(self) -> int:
        return len(self.p_1q)

    def readout_z_factor(self, q: int) -> float:
        """<Z_q> contraction from symmetric assignment error."""
        return 1.0 - 2.0 * float(self.readout[q])

    def ancilla_interferometric_factor(self, n_u2: int = 6) -> float:
        """Ancilla u2 depol events + ancilla readout, as one contraction."""
        p = float(np.mean(self.p_1q))  # ancilla ~ typical 1q error
        return ((1.0 - p) ** n_u2) * (1.0 - 2.0 * self.readout_ancilla)


def synthetic_eagle_calibration(n_qubits: int = 127, seed: int = 7) -> dict:
    """Deterministic Eagle/Heron-class calibration with typical magnitudes
    (1q ~2.5e-4, 2q ~8e-3, readout ~1.3e-2; log-normal spread).

    Keyed by the EXACT device graphs (eagle_coupling 127q /
    heron_coupling 133q) — the same graphs snake_layout walks — so every
    chain bond finds its per-edge error instead of silently falling back
    to the median (the generic heavy_hex_coupling approximation misses
    ~1/3 of the real devices' edges)."""
    rng = np.random.default_rng(seed)
    from dtc_tpu_torch.device.layouts import eagle_coupling, heron_coupling

    n, edges, _ = eagle_coupling() if n_qubits <= 127 else heron_coupling()
    return {
        "n_qubits": n,
        "single_qubit_error": {
            str(i): float(np.exp(rng.normal(np.log(2.5e-4), 0.5)))
            for i in range(n)
        },
        "two_qubit_error": {
            f"{a}-{b}": float(np.exp(rng.normal(np.log(8e-3), 0.5)))
            for a, b in edges
        },
        "readout_error": {
            str(i): float(np.exp(rng.normal(np.log(1.3e-2), 0.4)))
            for i in range(n)
        },
    }


def qiskit_properties_to_calibration(props: dict) -> dict:
    """Convert a Qiskit ``BackendProperties.to_dict()`` snapshot (the schema
    ``FakeBrisbane().properties()`` / a real IBM backend exports — what
    ``NoiseModel.from_backend`` consumes in the reference,
    autocorr-delta-a-single-qiskit-fast.py:77-79) into this module's
    calibration schema, so a REAL device snapshot drops in wherever the
    synthetic one is used.

    Mapping: per-qubit 1q error = the max gate_error over that qubit's
    physical 1q gates (sx/x/u3/r — rz is virtual/zero on IBM backends,
    excluded); per-edge 2q error = gate_error of the edge's ecr/cz/cx;
    readout_error from the per-qubit parameter list. Values may be plain
    numbers or {"name": ..., "value": ...} parameter dicts.
    """
    def pval(entry):
        return float(entry["value"] if isinstance(entry, dict) else entry)

    ro = {}
    for i, params in enumerate(props.get("qubits", [])):
        for prm in params:
            if prm.get("name") == "readout_error":
                ro[str(i)] = pval(prm)
    se: dict = {}
    te: dict = {}
    for gate in props.get("gates", []):
        name = gate.get("gate", "")
        qubits = gate.get("qubits", [])
        err = None
        for prm in gate.get("parameters", []):
            if prm.get("name") == "gate_error":
                err = pval(prm)
        if err is None:
            continue
        if len(qubits) == 1 and name in ("sx", "x", "u1", "u2", "u3", "r",
                                         "prx"):
            k = str(qubits[0])
            se[k] = max(se.get(k, 0.0), err)
        elif len(qubits) == 2 and name in ("ecr", "cz", "cx", "rzz"):
            a, b = qubits
            te[f"{a}-{b}"] = err
    n = max(len(props.get("qubits", [])),
            1 + max((int(k) for k in se), default=-1))
    if not (se and te and ro):
        raise ValueError("properties snapshot missing 1q/2q/readout errors")
    return {"n_qubits": n, "single_qubit_error": se,
            "two_qubit_error": te, "readout_error": ro}


def load_calibration(path: str) -> dict:
    """Load a calibration JSON — either this module's schema or a Qiskit
    BackendProperties snapshot (auto-detected and converted)."""
    with open(path) as f:
        cal = json.load(f)
    if "qubits" in cal and "gates" in cal:
        return qiskit_properties_to_calibration(cal)
    return cal


def model_from_calibration(cal: dict, chain_path: list[int],
                           ancilla: int | None = None) -> DeviceNoiseModel:
    """Map a device calibration onto an L-site chain via its snake path."""
    L = len(chain_path)
    se = cal["single_qubit_error"]
    te = cal["two_qubit_error"]
    ro = cal["readout_error"]

    def edge_err(a, b):
        return te.get(f"{a}-{b}", te.get(f"{b}-{a}", float(np.median(list(te.values())))))

    p1 = np.array([se[str(q)] for q in chain_path])
    p2 = np.array([edge_err(chain_path[i], chain_path[i + 1]) for i in range(L - 1)])
    rd = np.array([ro[str(q)] for q in chain_path])
    ra = float(ro[str(ancilla)]) if ancilla is not None else float(np.mean(rd))
    return DeviceNoiseModel(p_1q=p1, p_2q=p2, readout=rd, readout_ancilla=ra)


def brisbane_like_model(L: int, seed: int = 7) -> DeviceNoiseModel:
    """Synthetic-calibration Brisbane analogue for an L-chain
    (use_fakebackend=1 parity mode)."""
    from dtc_tpu_torch.device.layouts import snake_layout

    cal = synthetic_eagle_calibration(127, seed)
    lay = snake_layout(L, "brisbane")
    return model_from_calibration(cal, lay["path"], lay["ancilla"])


def synthetic_garnet_calibration(seed: int = 7) -> dict:
    """Deterministic Garnet-class (IQM 20q) calibration with typical
    magnitudes (1q ~1e-3, 2q ~5e-3, readout ~2e-2; log-normal spread),
    keyed by the exact garnet_coupling graph so every snake bond finds its
    per-edge error. The IQMFakeGarnet stand-in
    (autocorr-delta-a-single-qiskit-fast-energy-ham-comparison-iqm.py:83)."""
    rng = np.random.default_rng(seed + 101)  # stream distinct from eagle
    from dtc_tpu_torch.device.layouts import garnet_coupling

    n, edges, _ = garnet_coupling()
    return {
        "n_qubits": n,
        "single_qubit_error": {
            str(i): float(np.exp(rng.normal(np.log(1e-3), 0.4)))
            for i in range(n)
        },
        "two_qubit_error": {
            f"{a}-{b}": float(np.exp(rng.normal(np.log(5e-3), 0.4)))
            for a, b in edges
        },
        "readout_error": {
            str(i): float(np.exp(rng.normal(np.log(2e-2), 0.3)))
            for i in range(n)
        },
    }


def garnet_like_model(L: int, seed: int = 7) -> DeviceNoiseModel:
    """Synthetic-calibration Garnet analogue (L <= 19 plus ancilla on the
    20-qubit lattice) — the IQM counterpart of brisbane_like_model."""
    from dtc_tpu_torch.device.layouts import snake_layout

    cal = synthetic_garnet_calibration(seed)
    lay = snake_layout(L, "garnet")
    return model_from_calibration(cal, lay["path"], lay["ancilla"])


def fake_device_model(L: int, fake_device: str = "brisbane", seed: int = 7,
                      calibration_path: str | None = None) -> DeviceNoiseModel:
    """use_fakebackend=1 device selector: which QPU's calibration shape the
    noise model mimics (the reference switches by script variant —
    FakeBrisbane vs IQMFakeGarnet). calibration_path overrides the
    synthetic calibration with a REAL snapshot (this module's schema or a
    Qiskit BackendProperties JSON), mapped through the same snake layout."""
    if calibration_path:
        from dtc_tpu_torch.device.layouts import snake_layout

        cal = load_calibration(calibration_path)
        lay = snake_layout(L, fake_device)
        return model_from_calibration(cal, lay["path"], lay["ancilla"])
    if fake_device == "garnet":
        return garnet_like_model(L, seed)
    if fake_device == "brisbane":
        return brisbane_like_model(L, seed)
    raise ValueError(f"unknown fake_device {fake_device!r} "
                     "(expected 'brisbane' or 'garnet')")
