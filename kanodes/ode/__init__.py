from kanodes.ode.tableaus import TABLEAUS, Tableau
from kanodes.ode.integrate import (odeint, odeint_fixed, odeint_adjoint,
                                   odeint_members)

__all__ = ["TABLEAUS", "Tableau", "odeint", "odeint_fixed",
           "odeint_adjoint", "odeint_members"]
