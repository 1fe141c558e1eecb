"""Serving stack of the port (counterpart of kubeflow_tpu/serving)."""
