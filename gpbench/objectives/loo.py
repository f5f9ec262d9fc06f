"""The leave-one-out negative log likelihood (the objective of upstream's
``sinc_example --tune``), through the port's model metric."""

from albatross_tpu_torch.evaluation import LeaveOneOutLikelihood

METRIC = LeaveOneOutLikelihood()


def value(model, data):
    return METRIC(data, model)
