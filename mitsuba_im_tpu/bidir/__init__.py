"""Path-space (libbidir-analog) building blocks.

The reference's ``libbidir`` (``include/mitsuba/bidir/``) provides path
vertices/edges, BDPT sampling, five Markov-chain mutators, and the
specular-manifold machinery.  In this build, BDPT lives in
``integrators/bdpt.py`` (fixed-depth SoA subpaths) and MCMC in
``integrators/pssmlt.py`` (lockstep chain ensembles); this package holds
the remaining path-space tools, most importantly the batched specular
manifold walk (``manifold.py``).
"""
