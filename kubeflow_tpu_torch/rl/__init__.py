"""RL on the port (counterpart of kubeflow_tpu/rl): batched envs on the
device (`envs.py`), the Anakin learner with one CUDA graph an update
(`anakin.py`), the learner's config (`config.py`), its pod target
(`job.py`) and the solo-against-packed interference record
(`packing.py`)."""
