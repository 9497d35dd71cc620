from portbench.reference.models.hopenet import Hopenet
from portbench.reference.models.factory import D_MODEL_NAMES, G_MODEL_NAMES, build_models
