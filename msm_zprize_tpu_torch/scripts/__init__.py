"""Command-line tools of the port, each ``python3 -m
msm_zprize_tpu_torch.scripts.<name>`` with ``--device`` (default ``cuda``;
``cpu`` runs the plain twins): ``run_msm`` (one MSM at any curve and logN),
``evaluate_msm`` (the window sweep), ``field_benchmark`` (ns/op of the field
ops) and ``scaling_bench`` (the sharded MSM across mesh sizes). Twins of
the JAX package's ``scripts/`` of the same names; each ``main(argv)`` also
returns its numbers as a dict."""
