"""The plain reference: a path tracer and a train step in torch, from a
configuration's data, importing nothing of the renderer."""
