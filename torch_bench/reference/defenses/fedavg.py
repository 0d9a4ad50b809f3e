"""FedAvg (McMahan et al., AISTATS 2017): the rows' mean weighted by each
client's number of real samples. Summed in f64."""


def aggregate(rows, counts, config, selected=None):
    w = counts.double()
    return ((w @ rows.double()) / w.sum()).float()
