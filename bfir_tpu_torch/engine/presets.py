"""EQ preset files, byte-compatible with the reference's JSON schema.

Counterpart of ``bfir_tpu/engine/presets.py``. The plugin saves and loads
EQ presets from its preferences page via json_spirit
(``prefs_eq.cpp:469-521``): an object with ``cfg_eq_level`` (int, 0.1 dB
steps) and ``cfg_eq_mag`` (a comma-separated int string, common.h:28).
Presets written here load in the reference plugin and in ``bfir_tpu``, and
theirs load here.
"""

from __future__ import annotations

import json

from bfir_tpu_torch.core.spec import N_EQ_BANDS, EqSpec


def eq_to_preset_json(eq: EqSpec) -> str:
    return json.dumps(
        {
            "cfg_eq_level": eq.level_steps,
            "cfg_eq_mag": ",".join(str(v) for v in eq.mag_steps),
        },
        indent=1,
    )


def eq_from_preset_json(s: str, enabled: bool = True) -> EqSpec:
    data = json.loads(s)
    mags = [int(v) for v in str(data.get("cfg_eq_mag", "")).split(",")
            if v != ""]
    if len(mags) != N_EQ_BANDS:
        raise ValueError(
            f"preset has {len(mags)} bands, expected {N_EQ_BANDS}")
    return EqSpec(
        enabled=enabled,
        level_steps=int(data.get("cfg_eq_level", 0)),
        mag_steps=tuple(mags),
    )


def save_preset(path: str, eq: EqSpec) -> None:
    with open(path, "w") as f:
        f.write(eq_to_preset_json(eq))


def load_preset(path: str, enabled: bool = True) -> EqSpec:
    with open(path) as f:
        return eq_from_preset_json(f.read(), enabled=enabled)
