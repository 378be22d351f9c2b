"""crane_tpu_torch: the PyTorch and CUDA port of crane_tpu, for NVIDIA Hopper.

The package mirrors ``crane_tpu``'s layout and names, so each module's
counterpart is easy to find. It imports ``torch`` and never ``jax``, and
nothing of ``crane_tpu``: the few jax-free modules it needs from there (the
scheduler, sequence and stats of the engine, the bucket and hub helpers, the
generation config, the token stream and the tokenizer) are copies at the
same relative paths.

Every kernel that ``crane_tpu`` wrote in Pallas for the TPU and that this
port carries is a hand-written CUDA kernel for ``sm_90a`` under
``csrc/``, bound through :mod:`crane_tpu_torch.ops.cuda`. On a CUDA tensor
its wrapper launches the kernel or raises; on a CPU tensor it runs the
plain PyTorch version beside it.
"""

__version__ = "0.1.0"
