"""Host-side helpers of the port (counterparts of bnpc_tpu/utils/)."""
