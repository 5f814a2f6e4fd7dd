"""analytics_zoo_tpu_torch: the PyTorch / CUDA port of analytics_zoo_tpu.

The same layout and names as ``analytics_zoo_tpu``, so each module's
counterpart is easy to find; the internals are PyTorch (``nn.Module``s,
explicit devices, ``torch.Generator``s seeded from numpy) and every
Pallas TPU kernel the reference owns becomes a kernel written by hand
for Hopper (``ops/csrc``). The package imports nothing of JAX and
nothing of ``analytics_zoo_tpu``.

Entry points (``InferenceModel``, ``ZooModel.load_model``,
``serving.launch``) run on CUDA unless the caller passes
``device="cpu"``; with no GPU they raise.
"""

__version__ = "0.1.0"
