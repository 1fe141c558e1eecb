"""Model families of the port (counterpart of kubeflow_tpu/models)."""
