"""Small host-side utilities."""

from __future__ import annotations

from typing import Any, Dict


class Dict2Obj:
    """Attribute-style view over a dict (reference utils/tools.py:5-27
    capability — used there to reload args.json at eval time; the preferred
    path here is core.config.Config.load, but arbitrary JSON sidecars can be
    wrapped with this)."""

    def __init__(self, dictionary: Dict[str, Any]):
        for key, value in dictionary.items():
            setattr(self, key, value)

    def __repr__(self) -> str:
        attrs = ", ".join(f"{k}={v!r}" for k, v in vars(self).items())
        return f"Dict2Obj({attrs})"
