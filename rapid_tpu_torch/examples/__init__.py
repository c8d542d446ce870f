"""The port's runnable examples, each the counterpart of one JAX script in
``examples/`` with its file name and arguments: the Rapid agents
(``standalone_agent``, ``agent_grpc_transport``), the paper's experiments
and studies (``bootstrap_bench``, ``khl_sensitivity``,
``fleet_khl_autotune``, ``host_scale_ceiling``, ``udp_loss_curve``,
``virtual_cluster_demo``) and the kernel microbenchmark
(``kernel_microbench``, the counterpart of ``pallas_microbench.py``). Run
each as ``python -m rapid_tpu_torch.examples.<name>``; those that touch a
tensor take ``--device`` (CUDA unless another device is named)."""
