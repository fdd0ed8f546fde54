"""Out-of-core tiled film: bounded-memory accumulation + streamed EXR.

The analog of ``/root/reference/src/films/tiledhdrfilm.cpp:101`` (tiles
spill to disk through the OpenEXR tiled interface as workers finish).
Redesign: the image renders in horizontal *bands* — each band is a small
device film covering ``band_rows`` rows plus a filter-radius margin; after
its passes finish, the band accumulates into a host numpy memmap and its
device buffer is reused.  Develop streams memmap rows straight into the
scanline-EXR writer, so peak memory is one band + one compression block
regardless of image size.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import jax.numpy as jnp

from ..core.types import Float
from .film import DEFAULT_RADIUS


def render_tiled(scene, settings, out_path: str, spp: int | None = None,
                 band_rows: int = 64, half: bool = True,
                 metadata: dict | None = None) -> str:
    """Render ``scene`` band by band and write ``out_path`` (EXR)."""
    from ..render.job import _render_band
    from ..core import rng as mrng
    from ..sampler import KIND_BY_NAME
    from ..render.job import _integrator_fn
    from ..io.exr import write_exr_stream

    W, H = settings.width, settings.height
    spp = spp if spp is not None else settings.spp
    radius = settings.rfilter_radius or DEFAULT_RADIUS[settings.rfilter]
    margin = int(np.ceil(radius))
    kind = KIND_BY_NAME.get(settings.sampler, mrng.INDEPENDENT)
    li_fn = _integrator_fn(settings)

    tmp = tempfile.NamedTemporaryFile(suffix=".npy", delete=False)
    tmp.close()
    acc = np.lib.format.open_memmap(tmp.name, mode="w+", dtype=np.float32,
                                    shape=(H, W, 4))
    acc[:] = 0.0

    n_bands = (H + band_rows - 1) // band_rows
    for b in range(n_bands):
        row0 = b * band_rows
        band_h = band_rows + 2 * margin
        data = jnp.zeros((band_h, W, 4), Float)
        for s in range(spp):
            data = _render_band(
                scene, data, jnp.uint32(s), jnp.uint32(settings.seed),
                jnp.int32(row0), width=W, height=H, band_rows=band_rows,
                margin=margin, spp=spp, kind=kind, li_fn=li_fn,
                ftype=settings.rfilter, radius=radius)
        host = np.asarray(data)
        lo = max(row0 - margin, 0)
        hi = min(row0 + band_rows + margin, H)
        acc[lo:hi] += host[lo - (row0 - margin): hi - (row0 - margin)]

    def rows(y0, n):
        blk = acc[y0:y0 + n]
        w = np.maximum(blk[..., 3:4], 1e-8)
        return blk[..., :3] / w

    write_exr_stream(out_path, rows, H, W, 3, half=half, metadata=metadata)
    acc._mmap.close()
    os.unlink(tmp.name)
    return out_path
