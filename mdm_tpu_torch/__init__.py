"""mdm_tpu_torch: the PyTorch/CUDA port of mdm_tpu for one NVIDIA H100.

It mirrors mdm_tpu's module paths and public names. Ported so far: the
single-device text-to-motion sampling slice (trans_enc MDM, respaced
cosine DDPM with classifier-free guidance, hml_vec decode, the hash text
embedder and the serving wrapper), with the whole encoder layer as a chain
of hand-written Hopper kernels (ops/layer_inference.py); and single-device
training (train/: losses, AdamW + EMA, the train step and loop,
checkpoints), whose encoder layers run the train attention block and the
encoder tail, forward and backward, as hand-written kernel chains
(ops/attention_train_block.py, ops/encoder_tail.py); since then every
other path of mdm_tpu (DiP, the action-to-motion and t2m evaluation
protocols, the published weights, the T2M baseline) and its parallelism
(parallel/: data-parallel training and sampling over torch.distributed,
tensor-parallel sampling). It imports torch and numpy, never jax or flax.
"""
