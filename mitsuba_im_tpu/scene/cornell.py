"""The Cornell box as a mitsuba-format scene, shared by the tests and the
smoke and benchmark scripts.

Five diffuse walls (red left, green right as seen from the camera), a
small area light under the ceiling, a perspective camera looking down -z.
"""
from __future__ import annotations

CORNELL_XML = """\
<scene version="0.6.0">
    {integrator}
    <sensor type="perspective">
        <float name="fov" value="39.3"/>
        <transform name="toWorld">
            <lookat origin="0, 1, 3.9" target="0, 1, 0" up="0, 1, 0"/>
        </transform>
        <sampler type="independent">
            <integer name="sampleCount" value="{spp}"/>
        </sampler>
        <film type="hdrfilm">
            <integer name="width" value="{res}"/>
            <integer name="height" value="{res}"/>
            <rfilter type="box"/>
        </film>
    </sensor>
    <bsdf type="diffuse" id="white"><rgb name="reflectance" value="0.725 0.71 0.68"/></bsdf>
    <bsdf type="diffuse" id="red"><rgb name="reflectance" value="0.63 0.065 0.05"/></bsdf>
    <bsdf type="diffuse" id="green"><rgb name="reflectance" value="0.14 0.45 0.091"/></bsdf>

    <!-- floor -->
    <shape type="rectangle">
        <transform name="toWorld"><rotate x="1" angle="-90"/><scale value="1"/></transform>
        <ref id="white"/>
    </shape>
    <!-- ceiling -->
    <shape type="rectangle">
        <transform name="toWorld"><rotate x="1" angle="90"/><translate y="2"/></transform>
        <ref id="white"/>
    </shape>
    <!-- back wall -->
    <shape type="rectangle">
        <transform name="toWorld"><translate z="-1"/><translate y="1"/></transform>
        <ref id="white"/>
    </shape>
    <!-- left wall (red) -->
    <shape type="rectangle">
        <transform name="toWorld"><rotate y="1" angle="90"/><translate x="-1" y="1"/></transform>
        <ref id="red"/>
    </shape>
    <!-- right wall (green) -->
    <shape type="rectangle">
        <transform name="toWorld"><rotate y="1" angle="-90"/><translate x="1" y="1"/></transform>
        <ref id="green"/>
    </shape>
    <!-- light -->
    <shape type="rectangle">
        <transform name="toWorld"><rotate x="1" angle="90"/><scale value="0.25"/><translate y="1.99"/></transform>
        <ref id="white"/>
        <emitter type="area"><rgb name="radiance" value="17 12 4"/></emitter>
    </shape>
</scene>
"""


def cornell_xml(res: int, spp: int, max_depth: int = 5,
                integrator: str | None = None) -> str:
    """Scene text at ``res`` x ``res`` and ``spp``; ``integrator`` replaces
    the default ``path`` element (maxDepth ``max_depth``)."""
    if integrator is None:
        integrator = (f'<integrator type="path"><integer name="maxDepth" '
                      f'value="{max_depth}"/></integrator>')
    return CORNELL_XML.format(integrator=integrator, res=res, spp=spp)


def write_cornell(path: str, res: int, spp: int, max_depth: int = 5,
                  integrator: str | None = None) -> str:
    with open(path, "w") as f:
        f.write(cornell_xml(res, spp, max_depth, integrator))
    return path
