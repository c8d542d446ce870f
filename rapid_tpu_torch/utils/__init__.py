"""Host-side helpers of the port (copies of what it needs from
``rapid_tpu/utils``)."""
