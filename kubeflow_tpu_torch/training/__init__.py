"""Training on one GPU (counterpart of kubeflow_tpu/training): the
Trainer with its optimizer, synthetic data, MFU and the metrics stream."""
