"""The forward render of meshes and media through the split bounce: per
path segment the sorted driver counts (``with_stats`` segments), the
lane state read once and written once (origin, direction, time,
throughput, radiance and the alive flag in, 11 floats; the bounce's 15
outputs), the 8 bounce uniforms and the medium's one (read once), and
for a segment that scatters in the medium (``medium_segments``) its
candidate (the distance and the medium's material), written once (2
words); about 470 operations a segment (the shading, 300, the hash,
camera and roulette, 150, the flight's log and compare, 20).  Each
iteration reads the shell's and the boundary's packed tables once
(``table_bytes``).

Where it may overstate: a segment that ends in a miss or at the depth
cap needs fewer of its 15 outputs than are counted.  Where it
understates: no ray-triangle, ray-boundary or box test is counted, nor
the re-bin's sort and gathers, so the walks of K9 and K11b and the
driver's permutation lie outside it by design.
"""
SEGMENT_BYTES = 4 * (11 + 9 + 15)
MEDIUM_BYTES = 4 * 2
SEGMENT_OPS = 470


def work(c: dict) -> tuple[float, float]:
    seg, iters = float(c["segments"]), float(c["iterations"])
    return (SEGMENT_OPS * seg,
            SEGMENT_BYTES * seg + MEDIUM_BYTES * float(c["medium_segments"])
            + iters * float(c["table_bytes"]))
