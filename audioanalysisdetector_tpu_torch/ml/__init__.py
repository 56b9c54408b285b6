"""The classical-ML estimators in torch on the device (port only).

The JAX package's ``train/classical.py`` runs scikit-learn on the host;
the port depends on none of scikit-learn, joblib, pandas or xgboost, so
it carries its own: ``StandardScaler``, ``PCA``, ``FastICA``,
``SVC``, ``HistGradientBoostingClassifier``, ``Pipeline`` (with the
fitted-prefix cache that joblib.Memory gives the JAX package),
``GridSearchCV``, ``StratifiedKFold``, ``ParameterGrid``,
``train_test_split`` and the metrics. Each keeps sklearn 1.9's constructor
arguments, ``get_params`` / ``set_params`` with ``step__param`` names and
fitted attributes, takes ``device=`` (``"cuda"`` by default) and computes
in float64 there; random draws are numpy ``RandomState`` draws on the
host, as sklearn makes them. The module docstrings name what each copies
and where it departs.
"""

from audioanalysisdetector_tpu_torch.ml._base import clone
from audioanalysisdetector_tpu_torch.ml.decomposition import PCA, ConvergenceWarning, FastICA
from audioanalysisdetector_tpu_torch.ml.hist_gbdt import HistGradientBoostingClassifier
from audioanalysisdetector_tpu_torch.ml.metrics import accuracy_score, classification_report, f1_score
from audioanalysisdetector_tpu_torch.ml.model_selection import (
    GridSearchCV,
    ParameterGrid,
    StratifiedKFold,
    train_test_split,
)
from audioanalysisdetector_tpu_torch.ml.pipeline import FitCache, Pipeline
from audioanalysisdetector_tpu_torch.ml.preprocessing import StandardScaler
from audioanalysisdetector_tpu_torch.ml.svm import SVC

__all__ = [
    "PCA",
    "SVC",
    "ConvergenceWarning",
    "FastICA",
    "FitCache",
    "GridSearchCV",
    "HistGradientBoostingClassifier",
    "ParameterGrid",
    "Pipeline",
    "StandardScaler",
    "StratifiedKFold",
    "accuracy_score",
    "classification_report",
    "clone",
    "f1_score",
    "train_test_split",
]
