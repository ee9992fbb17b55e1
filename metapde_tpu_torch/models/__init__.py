from .siren import FieldDef, init_field_params, make_field, field_apply  # noqa: F401
