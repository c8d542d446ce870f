"""The port's command-line tools, each the counterpart of one JAX script in
``tools/`` with its file name and arguments: ``chaosrun`` (run, fuzz and
replay chaos scenarios), the operator's viewers ``traceview``,
``clustertop`` and ``perfview``, and ``collective_audit`` (the sharded
round's collective table). Run each as
``python -m rapid_tpu_torch.tools.<name>``."""
