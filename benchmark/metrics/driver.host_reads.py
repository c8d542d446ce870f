"""driver.host_reads: counted host reads (rapid_tpu_torch._host.read.count) per request."""


def read(run):
    return sum(r["host_reads"] for r in run.records) / len(run.records)
