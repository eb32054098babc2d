"""Datasets: ``SceneData`` and the loaders (``base.py``) and the synthetic
scene (``synthetic.py``). The names below load at first use, so a tool
that imports one module of this package (``prep.py``, ``colmap.py``)
imports no torch."""
import importlib

_SOURCES = {
    **dict.fromkeys(("SceneData", "detect_dataset_type", "load_scene"), "base"),
    **dict.fromkeys(("SphereScene", "default_scene", "make_dataset", "ray_batches", "render_scene", "scene_fields",
                     "tile_batches"), "synthetic"),
}

__all__ = list(_SOURCES)


def __getattr__(name):
    if name in _SOURCES:
        return getattr(importlib.import_module(f"{__name__}.{_SOURCES[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
