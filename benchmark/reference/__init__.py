"""The plain reference of the benchmark: NumPy only.

It imports nothing of the program under test. From the inputs the benchmark
makes (the seeded ring keys and identities, the churn of each request) it
works out again the view each request has to end in: the members, the
configuration id and the K rings (:mod:`benchmark.reference.membership`).
"""
