"""Evaluation (counterpart of mdm_tpu/eval): frozen evaluator nets, their
training, metrics, the t2m harness and the T2M baseline generator; the
action-to-motion half: the GRU and STGCN classifiers, their harness and
its setup."""
from . import (  # noqa: F401
    a2m_setup,
    classifiers,
    harness,
    harness_a2m,
    metrics,
    networks,
    stgcn,
    t2m_generator,
    train_evaluators,
)
from .evaluator import EvaluatorWrapper  # noqa: F401
from .harness import EvalConfig, GeneratedMotionLoader, MMGeneratedLoader, evaluation  # noqa: F401
from .t2m_generator import T2MBaselineGenerator, T2MBaselineLoader, T2MBaselineMMLoader  # noqa: F401
