"""The port's command-line tools, each run as
``python -m indextts_tpu_torch.tools.<name>`` and each with a ``main(argv)``
that callers can run in-process: checkpoint export, the verification
gate, quality evaluation, the benchmarks and the single-card entry."""
