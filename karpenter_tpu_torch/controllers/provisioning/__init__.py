from .batcher import Batcher
from .provisioner import ProvisionerController
from .controller import ProvisioningReconciler
from .volumetopology import VolumeTopology

__all__ = ["Batcher", "ProvisionerController", "ProvisioningReconciler", "VolumeTopology"]
