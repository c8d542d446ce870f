"""round.enqueue_ms.bootstrap: host time issuing a round of the bootstrap's
run_until_membership, in ms, unprofiled: the reading of round.enqueue_ms.latency
(the median over the program's unprofiled run_until_membership dispatch
records of (wall - counted-read time) / rounds). The growth view change and
its K-ring rebuild are in it. None where the program keeps no such record."""

from pathlib import Path

from benchmark import core

read = core.reader(Path(__file__).resolve().parents[2], "round.enqueue_ms.latency")
