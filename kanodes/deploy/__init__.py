"""Serving/deployment: trained models as portable compiled artifacts."""

from kanodes.deploy.export import (ServingArtifact, export_field,
                                   export_fn,
                                   export_graybox_trajectory,
                                   export_rhs, export_trajectory)

__all__ = [
    "ServingArtifact",
    "export_field",
    "export_fn",
    "export_rhs",
    "export_trajectory",
    "export_graybox_trajectory",
]
