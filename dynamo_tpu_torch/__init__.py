"""dynamo_tpu_torch — the PyTorch/CUDA port of dynamo_tpu.

It mirrors dynamo_tpu's layout module for module and imports nothing of it
(nor JAX): where it needs a JAX-free module of the reference it keeps its
own copy under the same relative path.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"``.
"""
