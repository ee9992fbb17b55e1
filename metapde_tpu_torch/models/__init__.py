from .siren import FieldDef, init_field_params, make_field, field_apply  # noqa: F401
from .field import make_div_free_field  # noqa: F401
