"""Figures of the experiment CSVs, one PNG each (with a fit-results CSV
where the reference writes one).

Port of ``dtc_tpu/analysis/plots.py``: its 11 figure functions, on the
port's ``analysis/envelope.py``, ``analysis/fft.py``, ``analysis/fits.py``
and ``io/csvio.py``. matplotlib (headless Agg backend) is imported inside
each function, not at module level as the reference does, so that the
port imports without it: only the figures need it.
"""

from __future__ import annotations

import os

import numpy as np

from dtc_tpu_torch.analysis.envelope import find_envelope
from dtc_tpu_torch.analysis.fft import spectrum, subharmonic_markers
from dtc_tpu_torch.analysis.fits import (
    energy_envelope_model,
    fit_energy_envelope,
    fit_power_law,
    fit_sincos_decay,
    min_energy_analysis,
    power_law,
    sincos_decay,
)
from dtc_tpu_torch.io import csvio


def pyplot():
    """matplotlib.pyplot on the Agg backend; ImportError naming matplotlib
    when it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the figures need matplotlib, which is not "
                          "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, out_png):
    os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
    fig.savefig(out_png, dpi=150, bbox_inches="tight")
    pyplot().close(fig)
    return out_png


def plot_autocorr(cols, out_png, title=""):
    """Forward / echo / sqrt(echo) traces (fast.py's terminal plot)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(7, 4))
    t = cols["time"]
    ax.plot(t, cols["av_autocorr"], "o-", ms=3, label=r"$A(t)$")
    if "av_autocorr_echo" in cols:
        ax.plot(t, cols["av_autocorr_echo"], "s-", ms=3, label=r"$A_0(t)$ echo")
        ax.plot(t, cols["sqrt_av_autocorr_echo"], "--", label=r"$\sqrt{A_0(t)}$")
    ax.set_xlabel("Floquet cycle t")
    ax.set_ylabel("autocorrelation")
    ax.set_title(title)
    ax.grid(alpha=0.3)
    ax.legend()
    return _save(fig, out_png)


def plot_with_envelopes(cols, out_png, key="av_autocorr", title=""):
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(7, 4))
    t = np.asarray(cols["time"])
    y = np.asarray(cols[key])
    up, lo = find_envelope(y)
    ax.plot(t, y, "o-", ms=3, label=key)
    ax.fill_between(t, lo, up, alpha=0.2, label="envelope")
    ax.set_xlabel("t")
    ax.grid(alpha=0.3)
    ax.legend()
    ax.set_title(title)
    return _save(fig, out_png)


def plot_sincos_fit(cols, out_png, key="av_autocorr", title=""):
    """Decaying sin+cos fit over a trace; returns (png, FitResult)."""
    plt = pyplot()
    t = np.asarray(cols["time"], dtype=float)
    y = np.asarray(cols[key], dtype=float)
    res = fit_sincos_decay(t, y)
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(t, y, "o-", ms=3, label=r"$\langle Z(t)\rangle$")
    if res.success:
        tf = np.linspace(t.min(), t.max(), len(t) * 10)
        p = res.params
        ax.plot(tf, sincos_decay(tf, p["A"], p["B"], p["omega"], p["gamma"],
                                 p["offset"]), "-", alpha=0.7, label="fit")
        ax.text(0.02, 0.02,
                f"C={p['A']:.3f} D={p['B']:.3f} f={p['frequency']:.3f} "
                f"γ={p['gamma']:.3f}",
                transform=ax.transAxes, fontsize=7,
                bbox=dict(boxstyle="round", fc="white", alpha=0.8))
    ax.set_ylim(-1.05, 1.05)
    ax.grid(alpha=0.3)
    ax.legend(fontsize=7)
    ax.set_title(title)
    return _save(fig, out_png), res


def plot_fit_grid(records, out_png, fit_csv=None, key="av_autocorr"):
    """Grid of sincos fits over (row, col) parameter cells + fit-results CSV
    (draw-2b-sincosfit.py / draw-autocorr-sincosfit-both.py)."""
    plt = pyplot()
    metas = [m for m, _ in records]
    rows = sorted({m["row"] for m in metas})
    cols_v = sorted({m["col"] for m in metas})
    fig, axes = plt.subplots(len(rows), len(cols_v),
                             figsize=(2.2 * len(cols_v), 1.8 * len(rows)),
                             squeeze=False)
    fit_rows = []
    for meta, data in records:
        i, j = rows.index(meta["row"]), cols_v.index(meta["col"])
        ax = axes[i][j]
        t = np.asarray(data["time"], dtype=float)
        y = np.asarray(data[key], dtype=float)
        res = fit_sincos_decay(t, y)
        ax.plot(t, y, "o-", ms=1.5, lw=0.8)
        if res.success:
            tf = np.linspace(t.min(), t.max(), len(t) * 10)
            p = res.params
            ax.plot(tf, sincos_decay(tf, p["A"], p["B"], p["omega"],
                                     p["gamma"], p["offset"]),
                    "-", alpha=0.6, lw=0.8)
        ax.set_ylim(-1.05, 1.05)
        ax.tick_params(labelsize=5)
        fit_rows.append(res.as_row(**{k: v for k, v in meta.items()}))
    if fit_csv:
        keys = list(fit_rows[0])
        csvio.write_columns(fit_csv, {k: [r[k] for r in fit_rows] for k in keys})
    return _save(fig, out_png), fit_rows


def plot_fft_subharmonics(cols, out_png, key="av_autocorr", title=""):
    """Amplitude spectrum with f=1/m markers (draw-2b-fft-sinfit.py:71-131)."""
    plt = pyplot()
    y = np.asarray(cols[key], dtype=float)
    freqs, amps = spectrum(y)
    res = fit_sincos_decay(np.asarray(cols["time"], dtype=float), y)
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(freqs, amps, "-o", ms=3)
    for f in subharmonic_markers():
        ax.axvline(f, color="gray", lw=0.6, ls=":")
    ax.axvline(0.5, color="tab:red", lw=1.0, ls="--", label="f = 1/2 (period doubling)")
    if res.success:
        ax.axvline(res.params["frequency"], color="tab:green", lw=1.0,
                   ls="-.", label=f"fitted f = {res.params['frequency']:.3f}")
    ax.set_xlabel("frequency (1/cycle)")
    ax.set_ylabel("|FFT|")
    ax.legend(fontsize=8)
    ax.set_title(title)
    return _save(fig, out_png)


def plot_energy_comparison(sources, out_png, *, per_qubit=False, L=None,
                           with_envelope_fit=True, with_power_law=False,
                           title=""):
    """Overlay E(t) from several sources (sim noise levels / hardware data),
    optional a(x+b)^c + d log(ex+f) + g envelope fits and min-energy markers
    (draw-energy-all.py:37-48,87-250; per-qubit variant
    draw-energy-all-per-qubit.py)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    for label, (t, e) in sources.items():
        t = np.asarray(t, dtype=float)
        e = np.asarray(e, dtype=float)
        if per_qubit and L:
            e = e / L
        ax.plot(t, e, "o-", ms=3, label=label)
        if with_envelope_fit and len(t) > 8:
            res = fit_energy_envelope(t, e)
            if res.success:
                tf = np.linspace(t.min(), t.max(), 200)
                p = res.params
                ax.plot(tf, energy_envelope_model(tf, *[p[k] for k in
                        ("a", "b", "c", "d", "e", "f", "g")]),
                        "--", alpha=0.5, lw=0.8)
        if with_power_law and len(t) > 4:
            res = fit_power_law(t, e)
            if res.success:
                tf = np.linspace(max(t.min(), 1e-3), t.max(), 200)
                p = res.params
                ax.plot(tf, power_law(tf, p["a"], p["b"], p["c"]), ":",
                        alpha=0.6, lw=0.9)
                ax.annotate(f"b={p['b']:.2f} (R²={res.r_squared:.3f})",
                            (t[-1], e[-1]), fontsize=7)
        imin = int(np.argmin(e))
        ax.plot(t[imin], e[imin], "v", ms=7, alpha=0.6)
    # min-energy analysis across all sources; takes RAW energies, it derives
    # the per-qubit values itself
    report = min_energy_analysis(sources, L=L)
    if report["per_source"]:
        row = report["per_source"][report["overall_min_source"]]
        # annotate in plot coordinates (E/L when per_qubit)
        y_min = (row["min_energy_per_qubit"] if per_qubit and L
                 else row["min_energy"])
        ax.annotate(
            f"min {y_min:.3f} @ t={row['t_min']:.0f}\n"
            f"({report['overall_min_source']})",
            (row["t_min"], y_min), fontsize=7,
            xytext=(5, -12), textcoords="offset points")
    ax.set_xlabel("Floquet cycle t")
    ax.set_ylabel("E/L" if per_qubit else "E")
    ax.grid(alpha=0.3)
    ax.legend(fontsize=8)
    ax.set_title(title)
    path = _save(fig, out_png)
    return {"path": path, "min_energy": report}


def plot_energy_with_echo_inset(energy_sources, echo_sources, out_png, *,
                                per_qubit=False, L=None, title=""):
    """Energy overlay with an echo inset in the lower-right corner
    (draw-energy-all-sub-echo.py:274-347: main axes = E(t) per source,
    inset = hardware av_autocorr_echo traces).

    energy_sources / echo_sources: {label: (t, values)} dicts.
    """
    plt = pyplot()
    from mpl_toolkits.axes_grid1.inset_locator import inset_axes

    fig, ax = plt.subplots(figsize=(8, 5))
    for label, (t, e) in energy_sources.items():
        e = np.asarray(e, dtype=float)
        if per_qubit and L:
            e = e / L
        ax.plot(np.asarray(t, dtype=float), e, "o-", ms=3, label=label)
    ax.set_xlabel("Floquet cycle t")
    ax.set_ylabel("E/L" if per_qubit else "E")
    ax.grid(alpha=0.3)
    ax.legend(fontsize=8, loc="upper left")
    ax.set_title(title)

    if echo_sources:
        ax_in = inset_axes(ax, width="45%", height="40%", loc="lower right")
        markers = ["o-", "s-", "^-", "d-"]
        for k, (label, (t, e)) in enumerate(echo_sources.items()):
            ax_in.plot(np.asarray(t, dtype=float), np.asarray(e, dtype=float),
                       markers[k % len(markers)], ms=2.5, lw=0.9, label=label)
        ax_in.set_ylabel(r"$A_0(t)$", fontsize=7)
        ax_in.tick_params(labelsize=6)
        ax_in.grid(alpha=0.25)
        ax_in.legend(fontsize=6)
    return _save(fig, out_png)


def plot_polarization_comparison(merged_cols, out_png, polarizations,
                                 title=""):
    """Per-polarization forward+echo panels (draw-polarization-comparison.py)."""
    plt = pyplot()
    n = len(polarizations)
    fig, axes = plt.subplots(2, n, figsize=(3.2 * n, 6), squeeze=False)
    t = merged_cols["time"]
    for j, pol in enumerate(polarizations):
        axes[0][j].plot(t, merged_cols[f"av_autocorr_{pol}"], "o-", ms=2)
        axes[0][j].set_title(f"pol={pol}", fontsize=9)
        axes[0][j].set_ylim(-1.05, 1.05)
        axes[1][j].plot(t, merged_cols[f"av_autocorr_echo_{pol}"], "s-", ms=2)
        axes[1][j].plot(t, merged_cols[f"sqrt_av_autocorr_echo_{pol}"], "--", lw=0.8)
        for ax in (axes[0][j], axes[1][j]):
            ax.grid(alpha=0.3)
    axes[0][0].set_ylabel("A(t)")
    axes[1][0].set_ylabel("echo")
    fig.suptitle(title)
    return _save(fig, out_png)


def plot_xy_cycle_comparison(curves, out_png, period=5, title=""):
    """XY-alternating vs pure-X with period gridlines
    (draw-xy-cycle-noise-comparison.py:7-120)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(8, 4))
    tmax = 0
    for label, (t, y) in curves.items():
        ax.plot(t, y, "o-", ms=3, label=label)
        tmax = max(tmax, int(np.max(t)))
    for x in range(0, tmax + 1, period):
        ax.axvline(x, color="gray", lw=0.5, ls=":")
    ax.set_xlabel("t")
    ax.set_ylabel("A(t)")
    ax.grid(alpha=0.2)
    ax.legend(fontsize=8)
    ax.set_title(title)
    return _save(fig, out_png)


def plot_csv_quicklook(csv_path, out_png, x="time", title=None):
    """Plot every numeric column of a CSV vs time (draw-fakebrisbane/torino)."""
    plt = pyplot()
    cols = csvio.read_columns(csv_path)
    fig, ax = plt.subplots(figsize=(7, 4))
    t = cols[x]
    for k, v in cols.items():
        if k == x or not np.issubdtype(np.asarray(v).dtype, np.number):
            continue
        ax.plot(t, v, "-o", ms=2, label=k, lw=0.9)
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)
    ax.set_title(title or os.path.basename(csv_path))
    return _save(fig, out_png)


def plot_adaptive_comparison(cols, out_png, *, target_echo=1.0,
                             g_min=0.84, g_max=1.0, title=""):
    """Three-panel adaptive-vs-fixed comparison: forward autocorrelation
    (with envelopes where present), echo vs the target line, and the
    realized g trajectory inside its [g_min, g_max] bounds — the
    controlled-g script's summary figure
    (autocorr-delta-a-single-qiskit-fast-controlled-g.py:739-806,
    adaptive_vs_fixed_g_comparison_*.png). `cols` is the adaptive data
    CSV's column dict (run_adaptive_realtime output schema)."""
    plt = pyplot()
    t = np.asarray(cols["time"], dtype=float)
    fig, (ax1, ax2, ax3) = plt.subplots(1, 3, figsize=(17.1, 4.3))

    series = (("adaptive", "av_autocorr_adaptive", "av_autocorr_echo_adaptive",
               "-", 2.5),
              ("g84", "av_autocorr_standard_g84", "av_autocorr_echo_standard_g84",
               "--", 2.0),
              ("g97", "av_autocorr_standard_g97", "av_autocorr_echo_standard_g97",
               "-.", 2.0))
    for label, fk, ek, ls, lw in series:
        if fk not in cols:
            continue
        ax1.plot(t, np.asarray(cols[fk], float), ls, lw=lw, label=f"A ({label})")
        ue, le = (f"upper_env_{label}_forward", f"lower_env_{label}_forward")
        if ue in cols:
            ax1.fill_between(t, np.asarray(cols[le], float),
                             np.asarray(cols[ue], float), alpha=0.12)
        ax2.plot(t, np.asarray(cols[ek], float), ls, lw=lw,
                 label=f"A0 ({label})")
    ax1.set_xlabel("t")
    ax1.set_ylabel("A(t)")
    ax1.legend(fontsize=8)
    ax2.axhline(target_echo, color="k", ls=":", lw=1, label="target")
    ax2.set_xlabel("t")
    ax2.set_ylabel("A0(t)")
    ax2.legend(fontsize=8)
    if "av_g_values" in cols:
        ax3.plot(t, np.asarray(cols["av_g_values"], float), "-", lw=2.5,
                 label="g(t)")
    for i in range(1, 100):
        k = f"g_history_inst{i}"
        if k not in cols:
            break
        ax3.plot(t, np.asarray(cols[k], float), alpha=0.35, lw=1)
    ax3.axhline(g_min, color="gray", ls=":", lw=1)
    ax3.axhline(g_max, color="gray", ls=":", lw=1)
    ax3.set_xlabel("t")
    ax3.set_ylabel("g")
    ax3.legend(fontsize=8)
    if title:
        fig.suptitle(title)
    return _save(fig, out_png)
