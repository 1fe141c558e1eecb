"""Observability of the port (counterpart of kubeflow_tpu/obs): the
build and runtime stamp."""
