"""Training on one GPU (counterpart of kubeflow_tpu/training): the
Trainer with its optimizer, the datasets and token-corpus loaders,
checkpoints and resume, the job target, MFU and the metrics stream."""
