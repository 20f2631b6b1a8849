"""The binarizer-family table and its spec parser, without torch.

``FAMILY[:PARAM=V,...]`` specs name a family of
:mod:`bdbnn_tpu_torch.nn.binarize` (the reference's table in
``bdbnn_tpu/nn/binarize.py``). The table and :func:`parse_binarizer`
live here, stdlib only, so a process that only validates specs (the
recipe-search harness, which owns no device) parses them without
loading torch; :mod:`~bdbnn_tpu_torch.nn.binarize` imports them from
here.
"""

from __future__ import annotations

from typing import Dict, Tuple

# family name -> (citation, stochastic, schedule length, param defaults)
_FAMILY_TABLE: Dict[str, Tuple[str, bool, int, Tuple[Tuple[str, float], ...]]] = {
    "ste": ("arXiv:1602.02830", False, 0, ()),
    "approx": ("arXiv:1808.00278", False, 0, ()),
    "ede": ("arXiv:1909.10788", False, 2, ()),
    "proximal": (
        "arXiv:2402.17710", False, 1,
        (("delta0", 2.0), ("delta1", 0.5)),
    ),
    "lab": ("arXiv:1611.01600", False, 0, ()),
    "stochastic": ("arXiv:1602.02830", True, 0, ()),
}

FAMILY_NAMES: Tuple[str, ...] = tuple(sorted(_FAMILY_TABLE))


def parse_binarizer(spec: str) -> Tuple[str, Dict[str, float]]:
    """Parse ``FAMILY[:PARAM=V,...]`` into ``(name, params)``, raising
    ``ValueError`` on unknown families, unknown params or bad values."""
    name, _, tail = spec.partition(":")
    name = name.strip()
    if name not in _FAMILY_TABLE:
        raise ValueError(
            f"unknown binarizer family {name!r} "
            f"(known: {', '.join(FAMILY_NAMES)})"
        )
    defaults = dict(_FAMILY_TABLE[name][3])
    params = dict(defaults)
    if tail:
        for item in tail.split(","):
            key, sep, val = item.partition("=")
            key = key.strip()
            if not sep or not key:
                raise ValueError(
                    f"bad binarizer param {item!r} in {spec!r} "
                    "(want PARAM=VALUE)"
                )
            if key not in defaults:
                raise ValueError(
                    f"binarizer family {name!r} has no param {key!r} "
                    f"(known: {sorted(defaults) or 'none'})"
                )
            try:
                params[key] = float(val)
            except ValueError as e:
                raise ValueError(
                    f"binarizer param {key}={val!r} is not a number"
                ) from e
            if params[key] <= 0:
                raise ValueError(
                    f"binarizer param {key} must be > 0, got {params[key]}"
                )
    return name, params


__all__ = ["FAMILY_NAMES", "parse_binarizer"]
