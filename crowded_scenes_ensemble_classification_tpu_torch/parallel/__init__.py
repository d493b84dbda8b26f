"""Parallel forms: streaming long-video windows (`streaming`).  The mesh,
halo and multi-process forms of the JAX package's `parallel/` are not
ported yet (ROADMAP Queue 1 item 7)."""
