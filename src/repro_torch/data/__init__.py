"""Training data for the paper's workloads (numpy, made from a seed)."""
from .synthetic import make_classification, make_images, make_svm_data

__all__ = ["make_classification", "make_images", "make_svm_data"]
