"""The negative log marginal likelihood, through the port's model API."""


def value(model, data):
    return -model.log_likelihood(data)
