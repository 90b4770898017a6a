"""The reference's scene suite (``test/Main.hs``) as runnable drivers
(``scenes/*.py`` of the JAX package), in the port.

Each scene module has ``world(rt)`` and ``settings(rt, width, spp,
depth)`` (``rt`` is the builder module: this package, or the JAX one in
the tests), ``build(args) -> (scene, settings, seed)`` and ``main(argv)``,
which renders the scene on the card (``--cpu`` for the CPU) and writes a
PNG through :func:`._common.scene_main`::

    python3 -m raytrace_tpu_torch.scenes.demo1 --spp 16

:mod:`.parity` renders the reference's configurations and compares them
with the reference's own PNGs and recorded brightness.  Importing this
package imports no scene.
"""
