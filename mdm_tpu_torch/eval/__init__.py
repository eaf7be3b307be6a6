"""Evaluation (counterpart of mdm_tpu/eval): frozen evaluator nets, their
training, metrics, the t2m harness and the T2M baseline generator. The
action-to-motion half (classifiers, STGCN, its harness) is ROADMAP Queue 1
item 9."""
from . import (  # noqa: F401
    harness,
    metrics,
    networks,
    t2m_generator,
    train_evaluators,
)
from .evaluator import EvaluatorWrapper  # noqa: F401
from .harness import EvalConfig, GeneratedMotionLoader, MMGeneratedLoader, evaluation  # noqa: F401
from .t2m_generator import T2MBaselineGenerator, T2MBaselineLoader, T2MBaselineMMLoader  # noqa: F401
