"""Convert the published text-encoder weights to the port's assets.

Counterpart of mdm_tpu/cli/convert_text_encoders.py:

    python -m mdm_tpu_torch.cli.convert_text_encoders \\
        --clip ViT-B-32.pt --bert distilbert-base-uncased/ --out_dir assets/text

``--clip`` takes an OpenAI ``clip`` checkpoint (a TorchScript archive or a
state dict; the visual tower is dropped) or a HuggingFace
CLIPTextModelWithProjection directory; ``--bert`` a HuggingFace
DistilBertModel directory or its ``.bin``. Each is mapped straight to the
state dict of the port's tower (models/text_encoders.py) and written with
``torch.save`` as ``clip_text_torch.pt`` / ``distilbert_torch.pt`` under
``--out_dir``, where ``sampling.text.make_text_embedder`` reads it. The
tokenizer files (``bpe_simple_vocab_16e6.txt.gz``, ``bert_vocab.txt``) go
beside them as mdm_tpu takes them.
"""
from __future__ import annotations

import argparse
import glob
import os


def _hf_bin(src: str) -> str:
    """The ``.bin`` state dict of a HuggingFace model directory."""
    bins = sorted(glob.glob(os.path.join(src, "*.bin")))
    if bins:
        return bins[0]
    if glob.glob(os.path.join(src, "*.safetensors")):
        raise ValueError(f"{src} holds only .safetensors weights, which need the safetensors "
                         "package; save the model as pytorch_model.bin "
                         "(save_pretrained(..., safe_serialization=False)) and convert that")
    raise FileNotFoundError(f"no .bin state dict under {src}")


def _load(path: str):
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def convert_clip(src: str, out_dir: str) -> str:
    import torch

    from ..models.text_encoders import convert_hf_clip_text, convert_openai_clip_text

    if os.path.isdir(src):
        sd = convert_hf_clip_text(_load(_hf_bin(src)))
    else:
        try:  # OpenAI's released .pt files are TorchScript archives
            sd = torch.jit.load(src, map_location="cpu").state_dict()
        except RuntimeError:
            sd = _load(src)
        sd = convert_openai_clip_text({k: v for k, v in sd.items() if not k.startswith("visual.")})
    path = os.path.abspath(os.path.join(out_dir, "clip_text_torch.pt"))
    torch.save(sd, path)
    print(f"saved {path}")
    return path


def convert_bert(src: str, out_dir: str) -> str:
    import torch

    from ..models.text_encoders import convert_hf_distilbert

    sd = convert_hf_distilbert(_load(_hf_bin(src) if os.path.isdir(src) else src))
    path = os.path.abspath(os.path.join(out_dir, "distilbert_torch.pt"))
    torch.save(sd, path)
    print(f"saved {path}")
    return path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--clip", default="", help="OpenAI clip .pt or HF directory")
    p.add_argument("--bert", default="", help="HF DistilBERT directory or .bin")
    p.add_argument("--out_dir", default="assets/text")
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    if args.clip:
        convert_clip(args.clip, args.out_dir)
    if args.bert:
        convert_bert(args.bert, args.out_dir)


if __name__ == "__main__":
    main()
