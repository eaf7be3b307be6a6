"""mdm_tpu_torch: the PyTorch/CUDA port of mdm_tpu for one NVIDIA H100.

It mirrors mdm_tpu's module paths and public names. Ported so far: the
single-device text-to-motion sampling slice (trans_enc MDM, respaced
cosine DDPM with classifier-free guidance, hml_vec decode, the hash text
embedder and the serving wrapper), with the whole encoder layer as a chain
of hand-written Hopper kernels (ops/layer_inference.py). It imports torch
and numpy, never jax or flax.
"""
