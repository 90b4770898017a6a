"""The forward render's work: per path segment the drivers count
(``with_stats`` segments), a bounce's lane columns, read once and
written once: origin, direction, time, throughput, radiance and the
alive flag in (11 floats), the 8 bounce uniforms, the 15 outputs;
``4 x (11 + 8 + 15)`` bytes; about 450 operations (the shading, 300,
and the hash, camera and roulette, 150).  Each iteration reads the
scene's packed table once (``table_bytes``).

Where it may overstate: none known; a segment is work the estimator
needs.  Where it understates: no ray-row test is counted, so a full
scan's work is outside it by design.
"""
SEGMENT_BYTES = 4 * (11 + 8 + 15)
SEGMENT_OPS = 450


def work(c: dict) -> tuple[float, float]:
    seg, iters = float(c["segments"]), float(c["iterations"])
    return (SEGMENT_OPS * seg,
            SEGMENT_BYTES * seg + iters * float(c["table_bytes"]))
