"""The port's entry points, one module each, named by a configuration's
``entry`` (``lzma2_stream`` where it names none; ``spec.entry``).

A module gives everything that depends on what a call hands the port:

* ``images(pool, files, payloads) -> (images, warm)``: each file's image,
  built from its pool blocks' payloads, and the warm-up image;
* ``work(image) -> (packed, unpacked)``: the LZMA2 chunk bytes an image
  holds, counted from its chunk headers (K1's bytes bound);
* ``Port(config, device)``: the port's call, ``port(image) -> bytes``, with
  ``reset_counters()`` and ``counters()``;
* ``Control(config)``: the control's decoder, called as the port is;
* ``CALL``: the name of the window's range around a call;
* ``TIMED``: ``(module, attribute, label, key)`` of the port's functions
  whose host time the traced run sums per call (``spans.Spans``);
* optionally ``prepare(pool, blocks, workers) -> built``: per-block data
  beyond the pool's, built where missing before ``images``.

A later entry point is a new module here and a configuration that names
it: no other file of the harness changes.
"""
