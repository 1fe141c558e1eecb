"""Observability of the port (counterpart of kubeflow_tpu/obs): the
build and runtime stamp, the serving plane's metrics registry and scrape
hooks, request-scoped tracing and the online SLO burn tracker."""
