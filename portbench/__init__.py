"""The benchmark of ``raytrace_tpu_torch`` on NVIDIA H100 cards.

``BENCHMARK.json`` at the repository's root names the cells; this
package finds everything of a cell by name: ``configs/<config>.json``
(a scene and camera, with its source and what was cut), ``traffic/
<traffic>.json`` (the load, whose ``entry`` names ``entries/<entry>.py``,
the timed loop), ``cells/<cell>.json`` (the cell's own settings and the
limits of ``correct``), ``metrics/<metric>.py`` (one reader a per-layer
metric) and ``rooflines/<kind>.py`` (work counts).  ``reference/`` is
the plain torch renderer the outputs are held to; ``control.py`` takes
the readings that set the limits.  ``python3 -m portbench.run`` runs a
cell (see ``run.py``).
"""
