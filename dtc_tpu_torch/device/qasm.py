"""OpenQASM 2.0 export of the kicked-Ising circuits.

Port of ``dtc_tpu/device/qasm.py`` (``circuit_to_qasm``, ``save_qasm``,
``parse_qasm_gates``): the text is generated from the port's
``KickSchedule`` (float64 angles, ``models/drives.py``), one gate a line,
angles as ``repr(float)``. Register convention of the reference circuit:
qubit 0 = ancilla, system qubits 1..L (system qubit q is exported as q+1).
"""

from __future__ import annotations

import numpy as np
import torch

from dtc_tpu_torch.models.drives import KickSchedule


def _fmt(x: float) -> str:
    return repr(float(x))


def _host(x) -> np.ndarray:
    """A float64 numpy copy of a tensor (on any device) or an array."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x)


def circuit_to_qasm(
    L: int,
    hs,
    phis,
    t: int,
    schedule: KickSchedule,
    *,
    echo: bool = False,
    initial_state: str = "vacuum",
    interferometric: bool = True,
    probe_qubit: int | None = None,
) -> str:
    """OpenQASM 2.0 program for the circuit at time t."""
    hs = _host(hs)[:L]
    phis = _host(phis)[: L - 1]
    angles = _host(schedule.angles)
    K = schedule.K
    q_probe = (L // 2) if probe_qubit is None else probe_qubit
    n = L + 1 if interferometric else L
    off = 1 if interferometric else 0  # system register offset

    lines = [
        "OPENQASM 2.0;",
        'include "qelib1.inc";',
        f"qreg q[{n}];",
        f"creg c[{1 if interferometric else L}];",
    ]
    if initial_state == "neel":
        for i in range(1, L, 2):
            lines.append(f"x q[{i + off}];")
    if interferometric:
        lines.append("h q[0];")
        lines.append(f"cz q[{q_probe + off}],q[0];")

    def emit_cycle(step: int, inverse: bool):
        sign = -1.0 if inverse else 1.0
        slot_order = range(K - 1, -1, -1) if inverse else range(K)

        def kicks():
            for k in slot_order:
                tx, ty = angles[step, k]
                ops = [("rx", tx), ("ry", ty)]
                if inverse:
                    ops = [(g, a) for g, a in reversed(ops)]
                for gate, a in ops:
                    if a != 0.0:
                        for i in range(L):
                            lines.append(f"{gate}({_fmt(sign * a)}) q[{i + off}];")

        def diag():
            for i in range(0, L - 1, 2):
                lines.append(f"rzz({_fmt(sign * phis[i])}) q[{i + off}],q[{i + 1 + off}];")
            for i in range(1, L - 1, 2):
                lines.append(f"rzz({_fmt(sign * phis[i])}) q[{i + off}],q[{i + 1 + off}];")
            for i in range(L):
                lines.append(f"rz({_fmt(sign * hs[i])}) q[{i + off}];")

        if inverse:
            diag()
            kicks()
        else:
            kicks()
            diag()

    for step in range(t):
        emit_cycle(step, inverse=False)
    if echo:
        for step in range(t - 1, -1, -1):
            emit_cycle(step, inverse=True)

    if interferometric:
        lines.append(f"cz q[{q_probe + off}],q[0];")
        lines.append("h q[0];")
        lines.append("measure q[0] -> c[0];")
    else:
        for i in range(L):
            lines.append(f"measure q[{i + off}] -> c[{i}];")
    return "\n".join(lines) + "\n"


def save_qasm(path: str, *args, **kw) -> str:
    text = circuit_to_qasm(*args, **kw)
    with open(path, "w") as f:
        f.write(text)
    return path


def parse_qasm_gates(text: str):
    """Minimal QASM gate-stream parser (round-trip validation utility):
    [(name, params, qubits)]."""
    out = []
    for line in text.splitlines():
        line = line.strip().rstrip(";")
        if not line or line.startswith(("OPENQASM", "include", "qreg", "creg")):
            continue
        if line.startswith("measure"):
            out.append(("measure", (), tuple()))
            continue
        if "(" in line:
            name, rest = line.split("(", 1)
            args_s, qubits_s = rest.split(")", 1)
            params = tuple(float(a) for a in args_s.split(","))
        else:
            name, qubits_s = line.split(" ", 1)
            params = ()
        qubits = tuple(int(tok.split("[")[1].rstrip("]"))
                       for tok in qubits_s.replace(" ", "").split(",") if tok)
        out.append((name.strip(), params, qubits))
    return out
