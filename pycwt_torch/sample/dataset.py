"""Bundled sample datasets (Torrence & Compo analysis workloads).

Counterpart of ``pycwt_tpu/sample/dataset.py``, reading this package's own
byte-for-byte copy of the ``.npz`` files under ``data/``.

Counterpart to the reference's ``pycwt/sample/dataset.py`` class (reference
``sample/dataset.py:22-135``), redesigned as a frozen record + loader over
``.npz`` files (the classic datasets — NINO3 SST, Mauna Loa CO₂, All-India
monsoon rainfall, Wolf sunspot numbers, SOI, Arctic Oscillation, Baltic sea
ice — repackaged from their published plain-text forms).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

#: Full presentation metadata matching the reference Dataset registry
#: (sample/dataset.py:60-135): title, label, plain + TeX-escaped units and
#: squared-units variants (what the demo scripts put on axes).  The jao /
#: jbaltic entries come from the reference's ``sample_xwt.py:36-37`` (its
#: registry never covered them).
_REGISTRY = {
    "nino3": dict(
        label="NINO3 SST", units="degC",
        title="NINO3 Sea Surface Temperature (seasonal)",
        units2="degC^2",
        tex_units=r"$^{\circ}\textnormal{C}$",
        tex_units2=r"$(^{\circ} \textnormal{C})^2$"),
    "mauna": dict(
        label="Mauna Loa CO2", units="ppm",
        title="Mauna Loa Carbon Dioxide",
        units2="ppm^2",
        tex_label=r"Mauna Loa CO$_{2}$", tex_units2=r"ppm$^2$"),
    "monsoon": dict(
        label="Rainfall", units="mm",
        title="All-India Monsoon Rainfall",
        units2="mm^2", tex_units2=r"mm$^2$"),
    "sunspots": dict(
        label="Sunspots", units="",
        title="Wolf's Sunspot Number", units2=""),
    "soi": dict(
        label="SOI", units="mb",
        title="Southern Oscillation Index",
        units2="mb^2", tex_units2=r"mb$^2$"),
    "jao": dict(
        label="AO", units="",
        title="Arctic Oscillation", units2=""),
    "jbaltic": dict(
        label="BMI", units="",
        title="Baltic Sea ice extent", units2=""),
}


@dataclasses.dataclass(frozen=True)
class Dataset:
    name: str
    values: np.ndarray
    t0: float
    dt: float
    label: str
    units: str
    title: str = ""
    units2: str = ""
    tex_label: str = ""
    tex_units: str = ""
    tex_units2: str = ""

    @property
    def time(self) -> np.ndarray:
        return self.t0 + np.arange(len(self.values)) * self.dt

    def standardized(self) -> np.ndarray:
        """Zero-mean, unit-std series (the canonical preprocessing of the
        sample scripts, reference ``sample/sample.py:51-57``)."""
        v = self.values
        return (v - v.mean()) / v.std()

    def labels(self, usetex: bool = False) -> dict:
        """``(title, label, units, units2)`` with the reference's
        ``usetex`` switch (sample/dataset.py:33-44): TeX-escaped variants
        when available and requested, plain text otherwise."""
        if usetex:
            return dict(title=self.title,
                        label=self.tex_label or self.label,
                        units=self.tex_units or self.units,
                        units2=self.tex_units2 or self.units2)
        return dict(title=self.title, label=self.label, units=self.units,
                    units2=self.units2)


def list_datasets() -> list[str]:
    return sorted(_REGISTRY)


def load(name: str) -> Dataset:
    """Load a bundled dataset by name (see :func:`list_datasets`)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; available: {list_datasets()}")
    path = os.path.join(_DATA_DIR, f"{name}.npz")
    with np.load(path) as z:
        values = z["values"]
        t0 = float(z["t0"])
        dt = float(z["dt"])
    meta = _REGISTRY[name]
    return Dataset(name=name, values=values, t0=t0, dt=dt,
                   label=meta["label"], units=meta["units"],
                   title=meta.get("title", ""),
                   units2=meta.get("units2", ""),
                   tex_label=meta.get("tex_label", ""),
                   tex_units=meta.get("tex_units", ""),
                   tex_units2=meta.get("tex_units2", ""))
