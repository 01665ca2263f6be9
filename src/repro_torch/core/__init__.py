"""The paper's system model: query patterns and their index,
pattern-induced subgraphs, placement under storage budgets, the cost model
(Eq. 5), the CRA closed form, B&B scheduling and the §5.1 baselines."""
