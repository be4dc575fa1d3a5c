from repro_torch.api.experiment import Experiment, PaperExperiment

__all__ = ["Experiment", "PaperExperiment"]
