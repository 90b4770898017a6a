"""The forward render of demo2 through the stationary driver's split
bounce: per path segment the driver counts (``with_stats`` segments),
the lane state read once and written once (origin, direction, time,
throughput, radiance and the alive flag in, 11 floats; the bounce's 15
outputs), the 8 bounce uniforms and the two media's (read once); about
490 operations a segment (the shading, 300, the hash, camera and
roulette, 150, each medium's flight, 20).  A segment that scatters in a
medium (``medium_segments``) writes its candidate (the distance and the
medium's material, 2 words).  A lane the rich-texture multiply
evaluates (``texture_lanes``) reads its texel (3 floats) and computes
the marble's stripe, 4,600 operations (seven octaves of eight hashed
gradient corners, each corner's avalanche, unit vector, dot product and
smoothstep weight, about 80; the sine).  Each iteration reads the
surface's and the media's packed tables once (``table_bytes``).

Where it may overstate: a segment that ends in a miss or at the depth
cap needs fewer of its 15 outputs than are counted; an earth lane
computes no stripe and a marble lane reads no texel, yet each textured
lane is counted with both.  Where it understates: no ray-row or box test
is counted, nor the rotation's masked rolls, so the BVH walk of K9 and
the driver's flush lie outside it by design.
"""
SEGMENT_BYTES = 4 * (11 + 10 + 15)
MEDIUM_BYTES = 4 * 2
TEXTURE_BYTES = 4 * 3
SEGMENT_OPS = 490
TEXTURE_OPS = 4600


def work(c: dict) -> tuple[float, float]:
    seg, iters = float(c["segments"]), float(c["iterations"])
    tex = float(c["texture_lanes"])
    return (SEGMENT_OPS * seg + TEXTURE_OPS * tex,
            SEGMENT_BYTES * seg + MEDIUM_BYTES * float(c["medium_segments"])
            + TEXTURE_BYTES * tex + iters * float(c["table_bytes"]))
