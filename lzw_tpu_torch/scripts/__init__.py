"""The JAX package's Pallas probes and ablations (``scripts/``), on the card.

Each module runs as ``python -m lzw_tpu_torch.scripts.<name>`` with the JAX
script's arguments and shapes: ``ablate_kernel`` (P1), ``ablate2`` (P2),
``probe_i16`` (P3) and ``probe_gpu`` (P4, the counterpart of
``probe_tpu.py``).  The first line names the card and its power limit;
the lines after it are the JAX script's, timed with CUDA events.  They need
a CUDA device and raise without one.  ``analyze_dictionary`` prints the
JAX script's dictionary-shape lines from ``ops.encode.encode_block``'s
slots, on ``--device`` (default ``cuda``; ``cpu`` runs the plain versions).
"""
