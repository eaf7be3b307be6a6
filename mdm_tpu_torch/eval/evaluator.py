"""Evaluator wrapper: frozen T2M co-embedding encoders, on one device.

Counterpart of mdm_tpu/eval/evaluator.py (reference EvaluatorMDMWrapper,
data_loaders/humanml/networks/evaluator_wrapper.py:121-186): movement
encoder on motion[..., :-4], m_lens // unit_length, then motion/text biGRU
embeddings. The masked biGRU needs no length-sorting, so embeddings come
back in input order.

Weights: the reference's ``finest.tar`` (torch state dicts under its
names), else ``finest.npy`` in mdm_tpu's flax layout (written by either
package's ``cli.train_evaluators --stage match``); the modules are sized
from the weights. With neither, random-init encoders, stamped ``degraded``.
The encoders run in float32 on ``device`` (the card unless ``"cpu"``),
TF32 off whatever the process allows (``networks.f32_math``);
``get_co_embeddings_device`` leaves the embeddings there.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.loader import put_one
from .networks import (
    MotionEncoderBiGRUCo,
    MovementConvEncoder,
    TextEncoderBiGRUCo,
    f32_math,
    load_flax_params,
    reset_seeded,
)


class EvaluatorWrapper:
    UNIT_LENGTH = 4

    def __init__(
        self,
        dataset_name: str = "humanml",
        checkpoints_dir: str = ".",
        params: Optional[dict] = None,
        movement_enc: Optional[MovementConvEncoder] = None,
        text_enc: Optional[TextEncoderBiGRUCo] = None,
        motion_enc: Optional[MotionEncoderBiGRUCo] = None,
        device="cuda",
    ):
        dim_pose = 263 if dataset_name == "humanml" else 251
        self.dim_pose = dim_pose
        self.device = torch.device(device)
        self.degraded: Optional[str] = None  # set when a fallback fires

        modules = None
        if params is None:
            ckpt_dir = "t2m" if dataset_name == "humanml" else dataset_name
            path = os.path.join(checkpoints_dir, ckpt_dir, "text_mot_match", "model", "finest.tar")
            native = path.replace("finest.tar", "finest.npy")
            if os.path.exists(path):
                modules = self.load_torch_checkpoint(path)
            elif os.path.exists(native):
                # Self-trained evaluators (eval/train_evaluators.py +
                # cli/train_evaluators.py of either package save this format).
                from .train_evaluators import load_evaluator_params

                params = load_evaluator_params(native)
        if modules is None and params is not None:
            # Sized from the weights unless the caller gives the modules, so
            # self-trained encoders of ANY size (cli.train_evaluators
            # --movement_dim/--coemb_dim) drive the protocol.
            inferred = self._modules_from_params(params)
            modules = tuple(m or i for m, i in zip((movement_enc, text_enc, motion_enc), inferred))
            for m, key in zip(modules, ("movement", "text", "motion")):
                load_flax_params(m, params[key])
        elif modules is None:
            # Metric numbers are meaningless without the frozen evaluators;
            # random init keeps smoke/dev runs alive.
            print(f"WARNING: evaluator checkpoint {path} missing; random init "
                  "(metrics will NOT be comparable to published numbers)")
            self.degraded = "random-init-evaluator-encoders"
            modules = tuple(reset_seeded(m, 0) for m in (
                movement_enc or MovementConvEncoder(dim_pose - 4, 512, 512),
                text_enc or TextEncoderBiGRUCo(300, 15, 512, 512),
                motion_enc or MotionEncoderBiGRUCo(512, 1024, 512)))
        self.movement_enc, self.text_enc, self.motion_enc = (
            m.to(self.device, torch.float32).eval().requires_grad_(False) for m in modules)

    @staticmethod
    def _modules_from_params(params):
        """Modules sized from the flax-layout weight shapes (any encoder width)."""

        def p(tree):
            return tree.get("params", tree)

        mov = p(params["movement"])
        mov_in, mov_hidden = (int(n) for n in np.shape(mov["conv1"]["kernel"])[1:])
        mov_out = int(np.shape(mov["conv2"]["kernel"])[2])
        text = p(params["text"])
        text_hidden = int(np.shape(text["input_emb"]["kernel"])[1])
        coemb = int(np.shape(text["output_net"]["fc2"]["kernel"])[1])
        mot = p(params["motion"])
        mot_in, mot_hidden = (int(n) for n in np.shape(mot["input_emb"]["kernel"]))
        return (
            MovementConvEncoder(mov_in, mov_hidden, mov_out),
            TextEncoderBiGRUCo(300, 15, text_hidden, coemb),
            MotionEncoderBiGRUCo(mot_in, mot_hidden, coemb),
        )

    @staticmethod
    def load_torch_checkpoint(path: str):
        """The reference's finest.tar -> (movement, text, motion) modules,
        sized from its state dicts and loaded under its names."""
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        mov, text, mot = (ckpt[k] for k in ("movement_encoder", "text_encoder", "motion_encoder"))
        mov_hidden, mov_in = mov["main.0.weight"].shape[:2]
        modules = (
            MovementConvEncoder(mov_in, mov_hidden, mov["main.3.weight"].shape[0]),
            TextEncoderBiGRUCo(300, 15, text["input_emb.weight"].shape[0],
                               text["output_net.3.weight"].shape[0]),
            MotionEncoderBiGRUCo(mot["input_emb.weight"].shape[1], mot["input_emb.weight"].shape[0],
                                 mot["output_net.3.weight"].shape[0]),
        )
        for m, sd in zip(modules, (mov, text, mot)):
            m.load_state_dict(sd)
        return modules

    def _put(self, x, dtype=torch.float32):
        return put_one(torch.as_tensor(x, dtype=dtype), self.device)

    @torch.inference_mode()
    @f32_math()
    def _embed_motion(self, motions, m_lens):
        movements = self.movement_enc(self._put(motions)[..., :-4])
        return self.motion_enc(movements, self._put(m_lens, torch.long) // self.UNIT_LENGTH)

    @torch.inference_mode()
    @f32_math()
    def _embed_text(self, word_embs, pos_ohot, cap_lens):
        return self.text_enc(self._put(word_embs), self._put(pos_ohot),
                             self._put(cap_lens, torch.long))

    def get_co_embeddings_device(self, word_embs, pos_ohot, cap_lens, motions, m_lens):
        """Tensors on the device: lets the harness run a whole loader pass
        without per-batch host syncs (pull once at the end)."""
        return (self._embed_text(word_embs, pos_ohot, cap_lens),
                self._embed_motion(motions, m_lens))

    def get_co_embeddings(
        self, word_embs, pos_ohot, cap_lens, motions, m_lens
    ) -> Tuple[np.ndarray, np.ndarray]:
        text_emb, motion_emb = self.get_co_embeddings_device(
            word_embs, pos_ohot, cap_lens, motions, m_lens
        )
        return text_emb.cpu().numpy(), motion_emb.cpu().numpy()

    def get_motion_embeddings(self, motions, m_lens) -> np.ndarray:
        return self._embed_motion(motions, m_lens).cpu().numpy()
