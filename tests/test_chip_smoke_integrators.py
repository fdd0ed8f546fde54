"""``chip_smoke.py``'s integrator phase rehearsed on the CPU: every
integrator the CLI dispatches renders a tiny Cornell box to a finite
image through the CLI."""
import pytest

import chip_smoke


@pytest.mark.parametrize("name", chip_smoke.INTEGRATORS)
def test_rehearse_integrator(tmp_path, name):
    info, _ = chip_smoke.phase_integrators(
        str(tmp_path), res=8, spp=1, max_depth=3, chains=64, photons=512,
        names=(name,))
    assert list(info) == [name]
