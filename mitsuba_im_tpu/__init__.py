"""mitsuba_im_tpu — a differentiable Monte Carlo renderer on JAX.

Built from scratch in JAX/XLA with the capability surface of the
reference C++ renderer mitsuba-im (interactive fork of Mitsuba 0.6): scene
XML loading, a wavefront path-tracing core with NEE + MIS, a plugin surface
of BSDFs/emitters/sensors/samplers/films/shapes/media, responsive
progressive rendering, and (beyond the reference) reverse-mode
scene-parameter gradients via path-replay backpropagation, sharded across
device meshes with shard_map.

Top-level imports are lazy (PEP 562) so pure-I/O tooling (mtsutil tonemap,
image conversion) never initializes JAX or touches the device.
"""

__version__ = "0.1.0"

_LAZY = {
    "Transform": ("mitsuba_im_tpu.core.transform", "Transform"),
    "Properties": ("mitsuba_im_tpu.core.properties", "Properties"),
    "load_scene": ("mitsuba_im_tpu.scene.xml", "load_scene"),
    "render": ("mitsuba_im_tpu.render.job", "render"),
    "core": ("mitsuba_im_tpu.core", None),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        m = importlib.import_module(mod)
        return m if attr is None else getattr(m, attr)
    raise AttributeError(f"module 'mitsuba_im_tpu' has no attribute '{name}'")
