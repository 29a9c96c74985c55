"""Protocol models of the port (counterpart of benor_tpu/models)."""
