from .costs import ClusterCosts, AppProfile, APPS
from .cluster import (simulate_run, SimResult, recovery_time, recovery_e2e,
                      rehost_break_even, replica_break_even,
                      simulate_scenario,
                      ScenarioSimResult)
