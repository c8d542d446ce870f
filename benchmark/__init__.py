"""The benchmark of ``rapid_tpu_torch`` on one H100: one run of one cell
(``run.py``), driven by ``BENCHMARK.json`` and the data files beside this
package (configurations, traffic mixes) and the metric readers."""
