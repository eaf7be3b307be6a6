"""Host-side data pipelines producing fixed-shape batches (counterpart of
mdm_tpu/data)."""
from .collate import collate_batch, collate_prefix, lengths_to_mask  # noqa: F401
from .humanml import HumanMLDataset, HumanMLOptions, MotionClip, load_clips  # noqa: F401
from .a2m import A2MConfig, ActionMotionDataset, HumanAct12, UESTC  # noqa: F401
from .loader import BatchIterator, get_dataset, get_dataset_loader  # noqa: F401
from .word_vectorizer import POS_ENUMERATOR, WordVectorizer  # noqa: F401
