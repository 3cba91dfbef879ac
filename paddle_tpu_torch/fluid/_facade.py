"""The module ``__getattr__`` of the port's ``fluid`` facade: a public
name of the reference's module that the port has not brought over
raises, naming its ROADMAP item."""


def not_ported(module):
    def __getattr__(name):
        if name.startswith("_"):
            raise AttributeError(
                f"module {module!r} has no attribute {name!r}")
        raise NotImplementedError(
            f"{module.replace('paddle_tpu_torch.', '')}.{name} is not "
            "ported (ROADMAP Queue 1 item 4, the rest of the package)")
    return __getattr__
