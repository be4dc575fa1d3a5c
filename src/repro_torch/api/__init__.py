from repro_torch.api.experiment import (Experiment, PaperExperiment,
                                       ZooExperiment)

__all__ = ["Experiment", "PaperExperiment", "ZooExperiment"]
